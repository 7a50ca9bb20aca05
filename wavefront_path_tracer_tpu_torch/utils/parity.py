"""The statistical equality rule between two renders of the same streams.

Two implementations of the fused kernel consume identical integer RNG
streams, but their float math may differ by ULPs: XLA's ops (the
reference package) against PyTorch's, or code built with FMA
contraction against code without.  Such a difference occasionally flips
which sphere a deep bounce hits, and that path then diverges.  Equality is therefore statistical: means agree
tightly and almost all pixels match.  The limits are the reference
package's (``tests/test_fused.py:_statistically_equal``), applied to
images averaged over samples.
"""

from __future__ import annotations

import numpy as np

MEAN_TOL = 2e-3
DISPLAY_RMSE_TOL = 5e-3
PIXEL_TOL = 1e-3
MAX_DIVERGED = 0.02
RAYS_REL_TOL = 0.01


def parity_report(a, b) -> dict:
    """Metrics of the rule for two (..., 3) sample-averaged radiance
    arrays (numpy or anything ``np.asarray`` takes)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    disp_a = np.sqrt(np.clip(a, 0.0, None))
    disp_b = np.sqrt(np.clip(b, 0.0, None))
    diff = np.abs(a - b).reshape(-1, 3).max(axis=-1)
    return {
        "finite": bool(np.isfinite(a).all() and np.isfinite(b).all()),
        "mean_diff": float(abs(a.mean() - b.mean())),
        "display_rmse": float(np.sqrt(np.mean((disp_a - disp_b) ** 2))),
        "diverged_share": float((diff > PIXEL_TOL).mean()),
        "max_abs_err": float(diff.max()) if diff.size else 0.0,
    }


def check_parity(a, b, rays_a=None, rays_b=None) -> dict:
    """Raise AssertionError unless ``a`` and ``b`` meet the rule (and,
    when given, ray counts agree within 1%); return the metrics."""
    rep = parity_report(a, b)
    problems = []
    if not rep["finite"]:
        problems.append("non-finite values")
    if not rep["mean_diff"] < MEAN_TOL:
        problems.append(f"|mean diff| {rep['mean_diff']:.3g} >= {MEAN_TOL}")
    if not rep["display_rmse"] < DISPLAY_RMSE_TOL:
        problems.append(f"display RMSE {rep['display_rmse']:.3g} >= "
                        f"{DISPLAY_RMSE_TOL}")
    if not rep["diverged_share"] < MAX_DIVERGED:
        problems.append(f"diverged pixel share {rep['diverged_share']:.3g} "
                        f">= {MAX_DIVERGED}")
    if rays_a is not None:
        rays_a, rays_b = float(rays_a), float(rays_b)
        rep["rays_rel_diff"] = abs(rays_a - rays_b) / max(rays_b, 1.0)
        if not rep["rays_rel_diff"] < RAYS_REL_TOL:
            problems.append(f"rays {rays_a:.0f} vs {rays_b:.0f} differ by "
                            f"more than {RAYS_REL_TOL:.0%}")
    if problems:
        raise AssertionError("renders differ: " + "; ".join(problems)
                             + f" ({rep})")
    return rep
