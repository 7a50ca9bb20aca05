"""Interactive (headless) render session — the event-loop layer.

Port of ``wavefront_path_tracer_tpu/app.py``.  Re-expresses the
reference's winit application shell (``gpu_wavefront_pt/src/app.rs``)
and its disabled imgui input path (``wavefront_common/src/gui.rs:63-199``)
without a window system: a session owns the renderer (on the card unless
``device`` names another), camera controller, and FPS meter; callers
feed it key/mouse events and step frames.  The redraw loop of the
reference (``app.rs:102-121``: fps update -> parameter sync -> render ->
request redraw) becomes ``step()``; camera mutation triggers the same
accumulation restart (``path_tracer.rs:240-277``) through
``Renderer.camera_changed``.  The accumulator stays on the device; each
frame that is shown or saved is copied to the host once.

Works as a programmatic API or as a minimal terminal REPL (``python -m
wavefront_path_tracer_tpu_torch.app``) that renders a preview PNG per
command.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from wavefront_path_tracer_tpu_torch.renderer import Renderer, RenderResult
from wavefront_path_tracer_tpu_torch.scene.camera import CameraController
from wavefront_path_tracer_tpu_torch.scene.scene import Scene
from wavefront_path_tracer_tpu_torch.utils.config import RenderConfig
from wavefront_path_tracer_tpu_torch.utils.profiling import FramesPerSecond

# Key bindings mirror the reference (gui.rs:91-134): WASD planar motion,
# Q/E up/down.
_KEY_ACTIONS = {
    "w": "move_forward",
    "s": "move_backward",
    "a": "move_left",
    "d": "move_right",
    "q": "move_up",
    "e": "move_down",
}


class InteractiveSession:
    """Headless interactive rendering: input events + progressive frames."""

    def __init__(self, scene: Scene, camera: CameraController,
                 config: RenderConfig, triangles=None, *, device="cuda"):
        self.camera = camera
        self.renderer = Renderer(scene, camera, config, triangles,
                                 device=device)
        self.fps = FramesPerSecond()
        self._last_step = time.perf_counter()

    # -- input events (app.rs:74-101 / gui.rs key handling) --
    def key_event(self, key: str, pressed: bool) -> None:
        action = _KEY_ACTIONS.get(key.lower())
        if action:
            getattr(self.camera, action)(pressed)

    def mouse_delta(self, dx: float, dy: float) -> None:
        self.camera.process_mouse(dx, dy)

    def look(self, dyaw_deg: float, dpitch_deg: float) -> None:
        """Turn the camera by a fixed angle (keyboard look).

        Unlike ``mouse_delta`` (whose rotation integrates over the next
        frame's dt, matching ``camera_controller.rs:150-153``), a key
        tap turns a deterministic amount regardless of frame time.
        """
        import math

        import numpy as np

        cam = self.camera.camera
        cam.yaw = float(cam.yaw + math.radians(dyaw_deg))
        cam.pitch = float(np.clip(cam.pitch + math.radians(dpitch_deg),
                                  -math.pi / 2 + 1e-3, math.pi / 2 - 1e-3))
        self.renderer.camera_changed()

    def resize(self, width: int, height: int) -> None:
        self.renderer.resize(width, height)

    def set_vfov(self, vfov_deg: float) -> None:
        self.camera.vfov_deg = vfov_deg
        self.renderer.camera_changed()

    def set_defocus(self, angle_deg: float, focus_distance: Optional[float] = None) -> None:
        self.camera.defocus_angle_deg = angle_deg
        if focus_distance is not None:
            self.camera.focus_distance = focus_distance
        self.renderer.camera_changed()

    # -- the redraw loop body (app.rs:102-121) --
    def step(self) -> Optional[RenderResult]:
        """Integrate camera motion for the elapsed dt, restart
        accumulation if the camera moved, render one SPF batch."""
        now = time.perf_counter()
        dt = now - self._last_step
        self._last_step = now

        before = (tuple(self.camera.camera.position),
                  self.camera.camera.pitch, self.camera.camera.yaw)
        self.camera.update_camera(dt)
        after = (tuple(self.camera.camera.position),
                 self.camera.camera.pitch, self.camera.camera.yaw)
        if before != after:
            self.renderer.camera_changed()

        self.fps.update()
        return self.renderer.render_frame()

    @property
    def progress(self) -> float:
        return self.renderer.progress.progress(
            self.renderer.config.samples_per_pixel)


def interactive_loop(session: InteractiveSession, out_png: str | None = None,
                     max_frames: int | None = None, stream=None,
                     input_stream=None, show_term: bool | None = None,
                     publish=None, key_source=None,
                     tonemap: str = "gamma2") -> int:
    """Live watch-and-steer loop — the reference's continuous redraw +
    input path (``app.rs:102-121``), headless.

    Every iteration: drain pending keys (non-blocking), apply them to
    the camera (movement integrates over the real frame dt; accumulation
    restarts on any change, ``path_tracer.rs:240-277``), render one SPF
    batch, and redraw the preview (ANSI terminal and/or PNG).  Converged
    frames idle (no re-render) until input arrives.

    ``key_source`` (optional) is a zero-arg callable returning any
    pending key characters from a second input channel — the --serve
    browser window's POSTed keydowns (``PreviewServer.pop_keys``) — so
    the served page both displays and steers, closing the loop with the
    reference's windowed input semantics.  With a key_source attached,
    stdin EOF does not end the session (the browser can still steer);
    'x' from either channel quits.

    Keys: w/a/s/d move, q/e up/down, i/k/j/l look up/down/left/right,
    [ ] vfov -/+, p save PNG, x quit.  Returns frames rendered.
    """
    import select

    from wavefront_path_tracer_tpu_torch.utils.image import (
        display_transform, write_png)
    from wavefront_path_tracer_tpu_torch.utils.preview import (
        term_preview_frame)

    stream = stream or sys.stderr
    stdin = input_stream if input_stream is not None else sys.stdin
    is_tty = hasattr(stdin, "isatty") and stdin.isatty()
    if show_term is None:
        show_term = is_tty
    old_attrs = None
    if is_tty:
        import termios
        import tty

        fd = stdin.fileno()
        old_attrs = termios.tcgetattr(fd)
        tty.setcbreak(fd)

    def pending_keys() -> str:
        """All keystrokes available right now (never blocks)."""
        keys = ""
        try:
            while select.select([stdin], [], [], 0)[0]:
                ch = stdin.read(1) if is_tty else stdin.readline()
                if not ch:  # EOF (piped input exhausted)
                    return keys + "\x04"
                keys += ch.strip() if not is_tty else ch
        except (OSError, ValueError):  # not selectable (StringIO in tests)
            chunk = stdin.read()
            keys += (chunk or "") + "\x04"
        return keys

    frames = 0
    eof = False
    last_result = None
    print("keys: w/a/s/d q/e move, i/k/j/l look, [ ] vfov, p png, x quit",
          file=stream)
    try:
        while max_frames is None or frames < max_frames:
            moved = False
            keys = pending_keys()
            if key_source is not None:
                keys += key_source() or ""
            for ch in keys:
                c = ch.lower()
                if c == "x":
                    return frames
                elif c == "\x04":
                    eof = True
                elif c in _KEY_ACTIONS:
                    session.key_event(c, True)
                    moved = True
                elif c in "ikjl[]":
                    # progress stays stale (1.0) until the restarted
                    # accumulation's next render, so force a frame.
                    moved = True
                    if c == "i":
                        session.look(0.0, 5.0)
                    elif c == "k":
                        session.look(0.0, -5.0)
                    elif c == "j":
                        session.look(5.0, 0.0)
                    elif c == "l":
                        session.look(-5.0, 0.0)
                    elif c == "[":
                        session.set_vfov(
                            max(1.0, session.camera.vfov_deg - 2.0))
                    else:
                        session.set_vfov(
                            min(170.0, session.camera.vfov_deg + 2.0))
                elif c == "p" and out_png and last_result is not None:
                    write_png(out_png, display_transform(
                        last_result.accumulated,
                        max(1, last_result.samples), tonemap))
                    print(f"\nwrote {out_png}", file=stream)

            if session.progress >= 1.0 and not moved \
                    and session.renderer.progress.accumulated_samples:
                if eof and key_source is None:
                    break  # converged and no more input can arrive
                time.sleep(0.05)  # converged: idle until input
                continue

            result = session.step()
            # A tapped movement key is a one-frame impulse: it was
            # pressed for exactly the step that just integrated it.
            for action in _KEY_ACTIONS.values():
                getattr(session.camera, action)(False)
            if result is None:
                continue
            last_result = result
            frames += 1

            cam = session.camera.camera
            status = (f"frame {frames}  {session.progress:5.0%} of "
                      f"{session.renderer.config.samples_per_pixel} spp  "
                      f"{session.fps.get_avg_fps():5.1f} fps  "
                      f"{result.mrays_per_s:7.1f} Mrays/s  "
                      f"pos=({cam.position[0]:.2f},{cam.position[1]:.2f},"
                      f"{cam.position[2]:.2f})")
            if show_term:
                term_preview_frame(result.image, status, stream=stream)
            else:
                print(status, file=stream)
            if out_png:
                samples = max(1, result.samples)
                write_png(out_png, display_transform(
                    result.accumulated, samples, tonemap))
            if publish is not None:
                publish(display_transform(result.accumulated,
                                          max(1, result.samples), tonemap),
                        samples=result.samples,
                        target_spp=session.renderer.config.samples_per_pixel,
                        mrays_per_s=result.mrays_per_s,
                        fps=session.fps.get_avg_fps(), frame=frames,
                        done=False, steerable=key_source is not None)
    finally:
        if old_attrs is not None:
            import termios

            termios.tcsetattr(stdin.fileno(), termios.TCSADRAIN, old_attrs)
    return frames


def final_image(session: InteractiveSession, tonemap: str = "gamma2"):
    """The session's display image from its accumulator, copied to the
    host once; None before the first sample."""
    from wavefront_path_tracer_tpu_torch.utils.image import (
        display_transform)

    renderer = session.renderer
    samples = renderer.progress.accumulated_samples
    if not samples:
        return None
    cfg = renderer.config
    accum = renderer._accum.reshape(cfg.height, cfg.width, 3).cpu().numpy()
    return display_transform(accum, samples, tonemap)


def repl(argv=None) -> int:
    """Tiny terminal loop: one-letter move commands, renders previews.
    Takes the CLI's flags (``cli.build_parser``); renders on ``--device``
    (default cuda)."""
    from wavefront_path_tracer_tpu_torch.cli import (
        build_camera,
        build_parser,
        build_scene,
        check_args,
        resolve_intersector,
    )
    from wavefront_path_tracer_tpu_torch.utils.image import write_png

    args = build_parser().parse_args(argv)
    check_args(args)
    scene, triangles, file_cam = build_scene(args)
    intersector, clusters, notes = resolve_intersector(
        args.intersector, args.clusters, scene, triangles, args.engine)
    for n in notes:
        print(n, file=sys.stderr)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples_per_pixel=args.spp, samples_per_frame=args.spf,
                       max_bounces=args.max_bounces, engine=args.engine,
                       intersector=intersector, baked_clusters=clusters)
    session = InteractiveSession(scene, build_camera(args, file_cam), cfg,
                                 triangles, device=args.device)

    print("commands: w/a/s/d/q/e move, r render-to-spp, p save png, x quit",
          file=sys.stderr)
    for line in sys.stdin:
        cmd = line.strip().lower()
        if cmd == "x":
            break
        elif cmd in _KEY_ACTIONS:
            session.key_event(cmd, True)
            session.step()
            session.key_event(cmd, False)
            print(f"pos={session.camera.camera.position}", file=sys.stderr)
        elif cmd == "r":
            while True:
                r = session.step()
                if r is None or session.progress >= 1.0:
                    break
            print(f"progress={session.progress:.0%} "
                  f"fps={session.fps.get_avg_fps():.1f}", file=sys.stderr)
        elif cmd == "p":
            session.renderer.render_frame()
            img = final_image(session, args.tonemap)
            write_png(args.out, img)
            print(f"wrote {args.out} @ "
                  f"{session.renderer.progress.accumulated_samples} spp",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(repl())
