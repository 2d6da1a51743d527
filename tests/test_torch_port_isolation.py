"""The port imports neither JAX nor the JAX package, and its entry points
run on CUDA unless the caller asks for the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mask_bev_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mask_bev_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [n for n in sys.modules if any(n == f or n.startswith(f + '.')"
        f" for f in {FORBIDDEN!r})]\n"
        "print(len([n for n in sys.modules if n.startswith(p.__name__)]))\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15  # every module was imported


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "mask_bev_tpu_torch.inference" in names
    assert not [n for n in names if _forbidden(n)]


def test_entry_points_default_to_cuda():
    from mask_bev_tpu_torch.config import tiny_test_config
    from mask_bev_tpu_torch.inference import MaskBevPredictor
    from mask_bev_tpu_torch.models.maskbev import MaskBev
    from mask_bev_tpu_torch.utils.precision import resolve_device

    cfg = tiny_test_config()
    sd = MaskBev(cfg).random_state_dict(0)
    if torch.cuda.is_available():
        assert MaskBevPredictor(cfg, sd).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            MaskBevPredictor(cfg, sd)
        with pytest.raises(RuntimeError, match="CUDA was requested"):
            resolve_device("cuda")
    assert MaskBevPredictor(cfg, sd, device="cpu").device.type == "cpu"


def test_kernel_wrappers_take_the_plain_path_only_on_cpu():
    """A CPU tensor runs the plain version and launches nothing."""
    from mask_bev_tpu_torch.kernels import build as kb
    from mask_bev_tpu_torch.ops import swin_block as ks

    kb.reset_launches()
    c, heads, win = 24, 3, 5
    g = torch.Generator().manual_seed(0)

    def dense(n, k):
        return ks.make_dense(torch.randn(n, k, generator=g) / k ** 0.5,
                             torch.zeros(n), False)

    p = ks.BlockWeights(
        torch.ones(c), torch.zeros(c), dense(3 * c, c), dense(c, c),
        torch.ones(c), torch.zeros(c), dense(4 * c, c), dense(c, 4 * c),
        torch.zeros(heads, win * win, win * win))
    x = torch.randn(1, 49, c, generator=g)
    out = ks.swin_block(x, p, (7, 7), win, heads, 0, False)
    torch.testing.assert_close(
        out, ks.swin_block_plain(x, p, (7, 7), win, heads, 0, False))
    assert sum(kb.LAUNCHES.values()) == 0


def test_new_weights_reach_the_kernel_copies():
    """Kernel-ready weight copies are rebuilt after load_state_dict."""
    from mask_bev_tpu_torch.config import tiny_test_config
    from mask_bev_tpu_torch.models.maskbev import MaskBev

    model = MaskBev(tiny_test_config())
    rng = torch.Generator().manual_seed(0)
    pts = torch.rand(1, 2048, 4, generator=rng) * 16 - 8
    msk = torch.ones(1, 2048, dtype=torch.bool)
    model.load_state_dict(model.random_state_dict(1))
    model(pts, msk)
    model.load_state_dict(model.random_state_dict(2))
    got = model(pts, msk).mask_logits
    fresh = MaskBev(tiny_test_config())
    fresh.load_state_dict(model.random_state_dict(2))
    torch.testing.assert_close(got, fresh(pts, msk).mask_logits)
