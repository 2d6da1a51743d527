"""Kernel 2's plain version (``ops/canvas.py::canvas_norm_plain``, which
the CUDA kernel is held to on the card) against the TPU kernel
``canvas_from_table(..., interpret=True, norm_stats=..., norm_affine=...)``
on the edge cases of the streaming kernel's row search: a sample with no
pillar, pillars in the first and the last cell, a sample whose every cell
is occupied with ``num_pillars`` equal to the table's N, a grid whose cell
count is not a multiple of a block's run, in both affine modes.

The inputs are ``test_torch_port_kernels.canvas_inputs``, the same bytes
whose kernel output the card holds to recorded digests. Tolerances,
relative to the reference's largest magnitude: f32 1e-6 (the same f32
operations; ``rsqrt`` may differ by an ulp between the two libraries),
bf16 one bf16 step (2^-8: the same f32 values rounded once).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mask_bev_tpu.ops.pallas_canvas import canvas_from_table  # noqa: E402
from mask_bev_tpu_torch.ops.canvas import (  # noqa: E402
    canvas_norm, canvas_norm_plain)
from test_torch_port_kernels import CANVAS_CASES, canvas_inputs  # noqa: E402

_DT = {"float32": (jnp.float32, torch.float32, 1e-6),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -8)}


@pytest.mark.parametrize("dtype", list(_DT))
@pytest.mark.parametrize("mode", ["full", "channel"])
@pytest.mark.parametrize("case", list(CANVAS_CASES))
def test_plain_matches_pallas_kernel(case, mode, dtype):
    jd, td, tol = _DT[dtype]
    table, cells, pillars, mean, var, scale, bias, (h, w) = canvas_inputs(
        case, mode)
    hw = h * w
    if case == "edges":
        assert int(pillars[0]) == 0 and (cells[0] == hw).all()
        assert int(cells[1, 0]) == 0 and int(cells[1, 3]) == hw - 1
        assert int(pillars[2]) == cells.shape[1] == hw
        assert torch.equal(cells[2], torch.arange(hw, dtype=torch.int32))
    table, scale, bias = (t.to(td) for t in (table, scale, bias))
    got = canvas_norm_plain(table, cells, mean, var, scale, bias, (h, w))
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(canvas_norm(table, cells, pillars, mean, var, scale,
                                   bias, (h, w)), got)
    want = canvas_from_table(
        jnp.asarray(table.float().numpy(), jd), jnp.asarray(cells.numpy()),
        None, (h, w), rows_per_block=8 if h % 8 == 0 else 4,
        norm_stats=(jnp.asarray(mean.numpy()), jnp.asarray(var.numpy())),
        norm_affine=(jnp.asarray(scale.float().numpy(), jd),
                     jnp.asarray(bias.float().numpy(), jd)),
        interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == td and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
