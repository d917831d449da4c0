"""The gradients of the port's lit shading against the JAX package's VJP on
the CPU (flat, gouraud and phong, with ``detach_bary`` on and off), on the
models, views and parameters of test_torch_lit.py (its images)."""

import numpy as np
import pytest

from test_torch_lit import AZIMS, LIGHTS, H, W, _renders


@pytest.mark.parametrize("detach_bary", [True, False])
@pytest.mark.parametrize("shading,light", [("flat", "directional"),
                                           ("gouraud", "point"),
                                           ("phong", "directional")])
def test_lit_gradients_match_jax(shading, light, detach_bary):
    """Every leaf's gradient of a weighted sum of the lit render against
    JAX's VJP, within 1e-4 of the leaf's largest."""
    w = np.random.default_rng(4).standard_normal((len(AZIMS), H, W, 3)).astype(np.float32)
    got, ref = _renders(dict(faces_per_pixel=2, shading_type=shading,
                             lights=LIGHTS[light], detach_bary=detach_bary),
                        with_grad=True, w=w)
    for k, want in ref.items():
        scale = np.abs(want).max()
        np.testing.assert_allclose(got[k], want, atol=1e-4 * max(scale, 1e-12), err_msg=k)
    # without detach_bary the pose learns through the texture sample too
    assert np.abs(ref["T"]).max() > 0
