"""Integrator engines.

Each engine module exposes::

    render_samples(scene_arrays, cam, view, inv_proj, config, frame,
                   sample_base, n_samples) -> ((num_pixels, 3) radiance sum,
                                               rays traced)

The port carries the fused engine, the megakernel oracle and the
wavefront engine.
"""


def get_engine(name: str):
    if name == "fused":
        from wavefront_path_tracer_tpu_torch.models import fused

        return fused
    if name == "megakernel":
        from wavefront_path_tracer_tpu_torch.models import megakernel

        return megakernel
    if name == "wavefront":
        from wavefront_path_tracer_tpu_torch.models import wavefront

        return wavefront
    raise KeyError(f"unknown engine {name!r}; have ['fused', 'megakernel', "
                   "'wavefront']")
