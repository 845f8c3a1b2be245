"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, sets its numerics guard at import, refuses to fall back to the CPU
silently, and keeps its console script and kernel sources packaged.

Also holds the port's tests that need a CUDA GPU (marker ``gpu``): they
skip where there is none and run on the GPU with
``python -m pytest --noconftest tests/test_torch_isolation.py -m gpu``
(``--noconftest``: the suite's conftest imports JAX, which the GPU machine
need not have)."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "vae_latent_geometry_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "optax", "vae_latent_geometry_tpu"}


def _sources():
    for dirpath, dirnames, files in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", "build")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_source_scan_finds_no_jax_import():
    seen = 0
    for path in _sources():
        seen += 1
        bad = FORBIDDEN.intersection(_imported_roots(path))
        assert not bad, f"{path} imports {bad}"
    assert seen > 15


def test_import_in_fresh_process_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import vae_latent_geometry_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'vae_latent_geometry_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_numerics_guard_is_set_after_import():
    import vae_latent_geometry_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_default_device_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from vae_latent_geometry_tpu_torch import resolve_device
    from vae_latent_geometry_tpu_torch.config import GeodesicConfig
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.optim.geodesic import optimize_splines

    model = os.path.join(REPO, "experiment", "model_seed42.npz")
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_npz(model)
    cpu = load_npz(model, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize_splines(cpu.decoders, np.zeros((1, 5, 2)), np.zeros((1, 2)),
                         np.ones((1, 2)), np.eye(16, 5), GeodesicConfig())
    r = subprocess.run(
        [sys.executable, "-m", "vae_latent_geometry_tpu_torch", "optimize",
         "--model", model, "--no-euclidean"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_console_script_and_package_data_in_pyproject():
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        cfg = tomllib.load(f)
    assert (cfg["project"]["scripts"]["vlg-torch"]
            == "vae_latent_geometry_tpu_torch.cli:main")
    data = cfg["tool"]["setuptools"]["package-data"]
    assert "ops/csrc/*.cu" in data["vae_latent_geometry_tpu_torch"]
    assert os.path.exists(os.path.join(PKG, "ops", "csrc",
                                       "energy_expected.cu"))


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "f32x3", "f32x2",
                                       "bfloat16"])
def test_kernels_match_plain_versions_on_gpu(precision):
    """K1 and K2 against their plain versions on the card, small shapes
    with a ragged tile edge (T*B not a multiple of the tile)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

    p = load_npz(os.path.join(REPO, "experiment", "model_seed42.npz"))
    ws, bs = ef.stack_weights(p.decoders)
    rng = np.random.default_rng(0)
    T, B = 67, 13
    g = torch.as_tensor(rng.normal(size=(T, B, 2)).astype(np.float32) * 2,
                        device="cuda")
    wmb = ef.active_weights(torch.as_tensor(rng.integers(1, 11, B)), 10, B,
                            "cuda")
    ct = torch.as_tensor(rng.uniform(0.5, 2, B).astype(np.float32),
                         device="cuda")
    e = ef.energy_fwd(ws, bs, g, wmb, precision)
    e_p = ef.energy_fwd_plain(ws, bs, g, wmb, precision)
    d = ef.energy_bwd(ws, bs, g, wmb, ct, precision)
    d_p = ef.energy_bwd_plain(ws, bs, g, wmb, ct, precision)
    torch.testing.assert_close(e, e_p, rtol=1e-5, atol=0)
    err = ((d - d_p).abs() / d_p.abs().max()).flatten()
    assert float(err.median()) < 1e-4
    assert float(torch.quantile(err, 0.99)) < 1e-3
