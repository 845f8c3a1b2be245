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
    yield os.path.join(REPO, "tools", "golden_tree.py")   # chip_smoke's


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


def test_figures_golden_and_utils_load_no_jax(tmp_path):
    """Drawing figures (matplotlib, seaborn, scipy) and running the golden,
    stability, interop and utils modules pulls in no JAX either."""
    code = (
        "import sys, numpy as np, torch\n"
        "from tools.golden_tree import write_tree\n"
        "from vae_latent_geometry_tpu_torch.viz import plotting\n"
        "from vae_latent_geometry_tpu_torch.pipeline import golden, stability\n"
        "from vae_latent_geometry_tpu_torch.models import torch_import\n"
        "from vae_latent_geometry_tpu_torch.utils import Timer, nan_guard\n"
        f"out = {str(tmp_path)!r}\n"
        "z = np.random.default_rng(0).normal(size=(200, 2)).astype('f4')\n"
        "plotting.plot_distance_matrix(np.eye(3), list('abc'), out + '/m.png')\n"
        "plotting.plot_cov_hist(z[:, 0] ** 2, out + '/h.png')\n"
        "plotting.plot_latents_with_selected(z, [{'index': 0}], out + '/l.png')\n"
        "root = write_tree(out + '/ref', n_classes=3, n_points=60)\n"
        "m, l = golden.golden_matrix(12, root)\n"
        "stability.frobenius_comparison(m, l, m, l)\n"
        "torch_import.load_single_vae_mean_decoder(\n"
        "    root + '/src/artifacts/vae_best_seed12.pth', 'cpu')\n"
        "with Timer(), nan_guard():\n"
        "    torch.ones(2).sum()\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'vae_latent_geometry_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'matplotlib' in sys.modules and 'seaborn' in sys.modules\n"
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


@pytest.mark.parametrize("mode", ["mc", "mc_scan", "mc_fused",
                                  "mc_fused_bf16"])
def test_mc_entry_points_raise_without_gpu(mode):
    """The MC modes run on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from vae_latent_geometry_tpu_torch.config import (EnergyConfig,
                                                      GeodesicConfig)
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.optim.geodesic import optimize_splines
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch)

    cpu = load_npz(os.path.join(REPO, "experiment", "model_seed42.npz"), "cpu")
    art = load_spline_batch(os.path.join(
        REPO, "experiment", "splines_init_model_seed42",
        "spline_batch_init_entropy_20.npz"))
    cfg = GeodesicConfig(steps=1, energy=EnergyConfig(num_t=8, mode=mode))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize_splines(cpu.decoders, art.omega_init[:1], art.a[:1],
                         art.b[:1], art.basis, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize_spline_batch(cpu, art, cfg=cfg)
    res = optimize_splines(cpu.decoders, art.omega_init[:1], art.a[:1],
                           art.b[:1], art.basis, cfg, device="cpu")
    assert torch.isfinite(res.energy).all()


def test_mc_kernel_wrappers_take_only_cpu_or_cuda_tensors():
    """A tensor that lies neither on the CPU nor on a CUDA device raises:
    the plain version is taken for CPU tensors only."""
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    g = torch.empty((8, 2, 2), device="meta")
    d = torch.empty((2, 7, 2), dtype=torch.int32, device="meta")
    k = torch.empty((2,), device="meta")
    for call in (lambda: mc.energy_mc_fwd([], [], g, d, d, "float32"),
                 lambda: mc.energy_mc_bwd([], [], g, d, d, k, "float32"),
                 lambda: mc.energy_mc_fwd_rng([], [], g, 0, k, 2, "float32"),
                 lambda: mc.energy_mc_bwd_rng([], [], g, 0, k, 2, k,
                                              "float32")):
        with pytest.raises(ValueError, match="no kernel for device"):
            call()
    assert all(v == 0 for n, v in mc.LAUNCHES.items() if "mc" in n)


def test_kernel_library_name_follows_included_headers(tmp_path, monkeypatch):
    """The build's file name hashes the source and every header under csrc/
    that it includes, so an edited header cannot load a stale library."""
    from vae_latent_geometry_tpu_torch.ops import _build

    headers = {
        "energy_expected": {"decode_mma.cuh", "decode_common.cuh",
                            "decode_f32.cuh", "decode_any.cuh",
                            "k1_fwd_f32.cuh", "tiles_mma.cuh",
                            "onepass_mma.cuh"},
        "energy_mc": {"decode_mma.cuh", "decode_common.cuh", "decode_f32.cuh",
                      "decode_any.cuh", "tiles_mma.cuh"},
        "energy_stats": {"decode_mma.cuh", "decode_common.cuh",
                         "decode_any.cuh"},
        "energy_transposed": {"decode_mma.cuh", "decode_common.cuh",
                              "decode_f32.cuh", "decode_any.cuh",
                              "k1_fwd_f32.cuh", "tiles_mma.cuh",
                              "onepass_mma.cuh"}}
    for name, want in headers.items():
        files = [p.name for p in _build.source_files(name)]
        assert files[0] == f"{name}.cu" and set(files[1:]) == want
        assert len(files) == len(want) + 1
    for f in os.listdir(_build.CSRC):
        (tmp_path / f).write_bytes((_build.CSRC / f).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._target(n).name for n in _build.SIGNATURES}
    # each header renames exactly the libraries that include it
    for header in ("decode_common.cuh", "decode_any.cuh", "decode_mma.cuh",
                   "decode_f32.cuh", "k1_fwd_f32.cuh", "tiles_mma.cuh",
                   "onepass_mma.cuh"):
        with open(tmp_path / header, "a") as f:
            f.write("// edited\n")
        after = {n: _build._target(n).name for n in _build.SIGNATURES}
        assert {n for n in before if before[n] != after[n]} == {
            n for n, want in headers.items() if header in want}, header
        before = after
    with open(tmp_path / "energy_mc.cu", "a") as f:
        f.write("// edited\n")
    assert _build._target("energy_mc").name != after["energy_mc"]
    assert _build._target("energy_expected").name == after["energy_expected"]


def test_console_script_and_package_data_in_pyproject():
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        cfg = tomllib.load(f)
    assert (cfg["project"]["scripts"]["vlg-torch"]
            == "vae_latent_geometry_tpu_torch.cli:main")
    data = cfg["tool"]["setuptools"]["package-data"]
    assert "ops/csrc/*.cu" in data["vae_latent_geometry_tpu_torch"]
    assert "ops/csrc/*.cuh" in data["vae_latent_geometry_tpu_torch"]
    for src in ("energy_expected.cu", "energy_mc.cu", "energy_stats.cu",
                "energy_transposed.cu", "decode_common.cuh",
                "decode_mma.cuh", "decode_any.cuh", "decode_f32.cuh",
                "k1_fwd_f32.cuh", "tiles_mma.cuh", "onepass_mma.cuh"):
        assert os.path.exists(os.path.join(PKG, "ops", "csrc", src))
    from setuptools import find_packages

    found = find_packages(REPO, **cfg["tool"]["setuptools"]["packages"]["find"])
    for sub in ("ops", "ops._research", "parallel", "graph", "pipeline",
                "optim"):
        assert f"vae_latent_geometry_tpu_torch.{sub}" in found


def test_new_modules_are_scanned_and_stats_kernel_is_registered():
    """The decoder-sharded path's modules are part of the port (so the
    no-JAX scans above cover them), and its CUDA source is one of the
    libraries the build knows."""
    from vae_latent_geometry_tpu_torch.ops import _build

    rel = {os.path.relpath(p, PKG) for p in _sources() if p.startswith(PKG)}
    for mod in ("parallel/mesh.py", "parallel/collectives.py",
                "parallel/multihost.py", "parallel/shard.py",
                "graph/grid.py", "graph/shortest_path.py",
                "pipeline/select_pairs.py", "pipeline/init_splines.py",
                "pipeline/full_run.py", "ops/_research/energy_fused_t.py"):
        assert mod in rel, mod
    assert set(_build.SIGNATURES) == {"energy_expected", "energy_mc",
                                      "energy_stats", "energy_transposed"}
    assert set(_build.SIGNATURES["energy_stats"]) == {"vlg_stats_fwd",
                                                      "vlg_stats_bwd"}


def test_init_and_mesh_entry_points_raise_without_gpu(tmp_path):
    """Init stages, the full pipeline and the mesh path run on the card
    unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from vae_latent_geometry_tpu_torch.config import (EnergyConfig,
                                                      GeodesicConfig,
                                                      InitConfig)
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh
    from vae_latent_geometry_tpu_torch.parallel.shard import (
        sharded_optimize_splines)
    from vae_latent_geometry_tpu_torch.pipeline.full_run import (
        run_distance_pipeline)
    from vae_latent_geometry_tpu_torch.pipeline.init_splines import (
        initialize_splines)

    model = os.path.join(REPO, "experiment", "model_seed42.npz")
    cpu = load_npz(model, "cpu")
    rng = np.random.default_rng(0)
    z = rng.normal(size=(40, 2)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_splines(z, [(0, 1)], cfg=InitConfig(grid_points_per_axis=8))
    init = initialize_splines(z, [(0, 1), (2, 3)], device="cpu",
                              cfg=InitConfig(grid_points_per_axis=8))
    assert init.omega.shape == (2, 5, 2) and np.isfinite(init.omega).all()
    x = rng.normal(size=(40, 50)).astype(np.float32)
    labels = np.array(["a", "b", "c", "d"] * 10)
    cfg = GeodesicConfig(steps=1, energy=EnergyConfig(num_t=8,
                                                      mode="expected_fused"))
    kw = dict(max_labels=3, init_cfg=InitConfig(grid_points_per_axis=8),
              geo_cfg=cfg, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_distance_pipeline(cpu, x, labels, **kw)
    out = run_distance_pipeline(cpu, x, labels, device="cpu",
                                mesh=make_mesh(1, 1), **kw)
    assert out.matrix.shape == (3, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded_optimize_splines(cpu.decoders, init.omega, init.a, init.b,
                                 init.basis, cfg, make_mesh(1, 1))
    for cmd in (["select-pairs", "--model", model],
                ["init-splines", "--model", model, "--pairfile", "none.json"]):
        r = subprocess.run(
            [sys.executable, "-m", "vae_latent_geometry_tpu_torch", *cmd],
            cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and "no CUDA device" in r.stderr, cmd


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def _random_decoders(rng, M, D, X, device):
    """(ws, bs) of M random ReLU MLPs D -> 128 -> 128 -> X, scaled so that
    the hidden units stay near half active."""
    def dev(x):
        return torch.as_tensor(x.astype(np.float32), device=device)

    ws = [dev(rng.normal(size=(M, D, 128)) / np.sqrt(D)),
          dev(rng.normal(size=(M, 128, 128)) * np.sqrt(2 / 128)),
          dev(rng.normal(size=(M, 128, X)) * np.sqrt(2 / 128))]
    bs = [dev(rng.normal(size=(M, n)) * 0.1) for n in (128, 128, X)]
    return ws, bs


@pytest.mark.gpu
@pytest.mark.parametrize("trans", [0, 1])
def test_mma_warp_gemm_matches_fp32_product_on_gpu(trans):
    """The tensor-core warp product of ``csrc/decode_mma.cuh`` alone (the
    forward operand through ldmatrix.trans, the chain's W^T without it) on
    bf16-exact inputs, against their product in float64: the products are
    exact in fp32, so only the fp32 accumulation differs (a ragged last
    block of rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.ops import _build
    from vae_latent_geometry_tpu_torch.ops.energy_fused import _stream

    rng = np.random.default_rng(trans)
    n = 300

    def bf16_exact(shape):
        x = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
        return x.to(torch.bfloat16).float().cuda().contiguous()

    h, w = bf16_exact((n, 128)), bf16_exact((128, 128))
    out = torch.empty((n, 128), device="cuda")
    _build.check(_build.library("energy_expected").vlg_mma_selftest(
        trans, h.data_ptr(), w.data_ptr(), out.data_ptr(), n,
        _stream(h.device)), "mma_selftest")
    torch.cuda.synchronize()
    wt = w.T if trans else w
    ref = h.double() @ wt.double()
    scale = h.abs().double() @ wt.abs().double()
    assert float(((out.double() - ref).abs() / scale).max()) < 2e-6


@pytest.mark.gpu
@pytest.mark.parametrize("X,D,M", [(50, 2, 10)] + [
    (x, d, m) for x in (7, 50, 64) for d in (1, 2, 4) for m in (1, 3)])
@pytest.mark.parametrize("precision", ["float32", "f32x3", "f32x2",
                                       "bfloat16"])
def test_kernels_match_plain_versions_on_gpu(precision, X, D, M):
    """K1 and K2 against their plain versions on the card, small shapes
    with a ragged tile edge (T*B not a multiple of the tile): the committed
    model (X, D, M = 50, 2, 10) and random decoders at the widths the
    kernels take (K2's tensor-core layer 3 pads X to 8, its chain to 16).
    Two K2 calls on the same input are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

    rng = np.random.default_rng(0)
    if (X, D, M) == (50, 2, 10):
        p = load_npz(os.path.join(REPO, "experiment", "model_seed42.npz"))
        ws, bs = ef.stack_weights(p.decoders)
    else:
        ws, bs = _random_decoders(rng, M, D, X, "cuda")
    T, B = 67, 13
    g = torch.as_tensor(rng.normal(size=(T, B, D)).astype(np.float32) * 2,
                        device="cuda")
    wmb = ef.active_weights(torch.as_tensor(rng.integers(1, M + 1, B)), M, B,
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
    assert torch.equal(d, ef.energy_bwd(ws, bs, g, wmb, ct, precision))


def _shape_decoders(name, device):
    """Decoder ``name`` of tools/jax_reference_shapes.py (seeded S1-S5) as
    (ws, bs); the generator imports no JAX at module level."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_reference_shapes",
        os.path.join(REPO, "tools", "jax_reference_shapes.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    layers = ref.shape_layers(name)
    return ([torch.as_tensor(w, device=device) for w, _ in layers],
            [torch.as_tensor(b, device=device) for _, b in layers])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["S2", "S4"])
@pytest.mark.parametrize("mode,ep", [
    ("expected_fused", False), ("expected_fused_bf16", False),
    ("mc_fused", False), ("single_fused", False),
    ("single_fused_bf16", False), ("expected_fused", True)])
def test_fused_modes_run_on_other_decoder_shapes_on_gpu(mode, ep, shape):
    """Decoders of other depths and widths than the production model's
    (2 -> 64 -> 64 -> 50 and 2 -> 96 -> 160 -> 48 -> 100, ten members) on the
    card: every fused mode, sharded (``ep_axis``) or not, runs its kernels
    (their launch counters move) and matches the plain mode's energies on
    the same model: ``expected`` (``mc_fused`` with one active decoder, so
    every draw names decoder 0, against ``expected`` with one) and
    ``single``.  rtol 1e-5 at float32; the ``_bf16`` modes round every
    operand to bf16 (2^-9 relative), rtol 1e-2 on these random curves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.config import (EnergyConfig,
                                                      GeodesicConfig)
    from vae_latent_geometry_tpu_torch.geometry.basis import nullspace_basis
    from vae_latent_geometry_tpu_torch.models.evae import decoder_member
    from vae_latent_geometry_tpu_torch.ops import energy_fused
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused  # noqa: F401
    from vae_latent_geometry_tpu_torch.optim import geodesic as tgeo
    from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(1)

    def dev(x):
        return torch.as_tensor(x.astype(np.float32), device="cuda")

    ws, bs = _shape_decoders(shape, "cuda")
    dec = {"layers": [{"w": w, "b": b} for w, b in zip(ws, bs)]}
    plain = "expected"
    if mode.startswith("single"):
        dec, plain = decoder_member(dec, 0), "single"
    num_active = (torch.ones(4, dtype=torch.int32, device="cuda")
                  if mode == "mc_fused" else None)
    basis, _ = nullspace_basis(4)
    om, a, b = (dev(rng.normal(size=s)) for s in
                ((4, basis.shape[1], 2), (4, 2), (4, 2)))

    def energies(m, **kw):
        cfg = GeodesicConfig(energy=EnergyConfig(
            num_t=32, mode=m, kernel_precision="float32", **kw))
        loss = tgeo.make_loss_fn(dec, basis, cfg, "cuda",
                                 mesh=make_mesh(1, 1) if ep else None)
        return loss(om, a, b, 0, num_active)[1]

    energy_fused.reset_launch_counts()    # the MC kernels' counts too
    e = energies(mode, ep_axis="ep" if ep else None)
    torch.cuda.synchronize()
    assert any(energy_fused.LAUNCHES.values())
    e_plain = energies(plain)
    rtol = 1e-2 if mode.endswith("bf16") else 1e-5
    torch.testing.assert_close(e, e_plain, rtol=rtol, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["S1", "S2", "S3", "S4", "S5"])
@pytest.mark.parametrize("precision", ["float32", "f32x3", "f32x2",
                                       "bfloat16"])
def test_every_kernel_matches_its_plain_version_on_other_shapes_on_gpu(
        precision, shape):
    """K1-K10 (K9/K10 at the 3-layer shapes) on the generic decode
    (``csrc/decode_any.cuh``) against their plain versions on the card,
    T = 64 and B = 13 (a ragged tile edge), mixed per-spline decoder
    counts, under chip_smoke.py's kernel limits: energies rtol 1e-5, and
    5e-5 at bfloat16 (E_RTOL_MC_BF16: a one-ulp difference of the two
    summation orders flips a decoder output's bf16 rounding, and with S1's
    three decoders, as with one MC endpoint, the flips are not averaged
    over ten: K1 read 1.07e-5 there on an H100), dgamma median 1e-4 and
    99th percentile 1e-3 of its largest element, the statistics at
    STATS_X_RTOL / STATS_SQ_RTOL; every call repeated bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc
    from vae_latent_geometry_tpu_torch.ops._research import (
        energy_fused_t as eft)

    ws, bs = _shape_decoders(shape, "cuda")
    M, X = ws[0].shape[0], ws[-1].shape[-1]
    rng = np.random.default_rng(2)
    T, B = 64, 13

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device="cuda")

    g = dev(rng.normal(size=(T, B, 2)) * 1.5)
    ct = dev(rng.uniform(0.5, 2, B))
    wmb = ef.active_weights(torch.as_tensor(rng.integers(1, M + 1, B)), M, B,
                            "cuda").contiguous()
    e_tol = 5e-5 if precision == "bfloat16" else 1e-5

    def same(fn):
        out = fn()
        again = fn()
        outs = out if isinstance(out, tuple) else (out,)
        agains = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(o, a) for o, a in zip(outs, agains))
        return out

    def energy(fn, fn_p, rtol=1e-5):
        torch.testing.assert_close(same(fn), fn_p(), rtol=rtol, atol=0)

    def dgamma(fn, fn_p):
        d, d_p = same(fn), fn_p()
        err = ((d - d_p).abs() / d_p.abs().max()).flatten()
        assert float(err.median()) < 1e-4
        assert float(torch.quantile(err, 0.99)) < 1e-3

    energy(lambda: ef.energy_fwd(ws, bs, g, wmb, precision),
           lambda: ef.energy_fwd_plain(ws, bs, g, wmb, precision), e_tol)
    dgamma(lambda: ef.energy_bwd(ws, bs, g, wmb, ct, precision),
           lambda: ef.energy_bwd_plain(ws, bs, g, wmb, ct, precision))
    out = same(lambda: ef.stats_fwd(ws, bs, g, wmb, precision))
    ref = ef.stats_fwd_plain(ws, bs, g, wmb, precision)
    x_tol, sq_tol = (1e-2, 5e-2) if precision == "bfloat16" else (5e-5, 5e-4)
    x_scale = float(ref[0].abs().max())
    assert float((out[0] - ref[0]).abs().max()) <= x_tol * x_scale
    assert float((out[1] - ref[1]).abs().max()) <= x_tol * x_scale
    assert float((out[2] - ref[2]).abs().max()) <= sq_tol * max(
        float(ref[2].abs().max()), 1e-30)
    cts = [dev(rng.normal(size=s)) for s in ((T, B, X), (T, B, X), (T, B))]
    dgamma(lambda: ef.stats_bwd(ws, bs, g, wmb, *cts, precision),
           lambda: ef.stats_bwd_plain(ws, bs, g, wmb, *cts, precision))
    d1, d2 = mc.sample_decoder_indices(
        torch.Generator(device="cuda").manual_seed(5), T, B, M, 2,
        torch.as_tensor(rng.integers(1, M + 1, B), device="cuda"))
    energy(lambda: mc.energy_mc_fwd(ws, bs, g, d1, d2, precision),
           lambda: mc.energy_mc_fwd_plain(ws, bs, g, d1, d2, precision), e_tol)
    dgamma(lambda: mc.energy_mc_bwd(ws, bs, g, d1, d2, ct, precision),
           lambda: mc.energy_mc_bwd_plain(ws, bs, g, d1, d2, ct, precision))
    seed, kmax = (1 << 40) + 3, torch.full((B,), float(M), device="cuda")
    energy(lambda: mc.energy_mc_fwd_rng(ws, bs, g, seed, kmax, 2, precision),
           lambda: mc.energy_mc_fwd_rng_plain(ws, bs, g, seed, kmax, 2,
                                              precision), e_tol)
    dgamma(lambda: mc.energy_mc_bwd_rng(ws, bs, g, seed, kmax, 2, ct,
                                        precision),
           lambda: mc.energy_mc_bwd_rng_plain(ws, bs, g, seed, kmax, 2, ct,
                                              precision))
    if len(ws) == 3:
        energy(lambda: eft.energy_t_fwd(ws, bs, g, precision),
               lambda: eft.energy_t_fwd_plain(ws, bs, g, precision), e_tol)
        dgamma(lambda: eft.energy_t_bwd(ws, bs, g, ct, precision),
               lambda: eft.energy_t_bwd_plain(ws, bs, g, ct, precision))


@pytest.mark.gpu
@pytest.mark.parametrize("mc_samples", [2, 3])
@pytest.mark.parametrize("precision", ["float32", "f32x3", "f32x2",
                                       "bfloat16"])
def test_mc_kernels_match_plain_versions_on_gpu(precision, mc_samples):
    """K5-K8 against their plain versions on the card, small shapes with
    ragged tile edges, mixed per-spline decoder counts; K7/K8 are K5/K6 on
    the planes of ``philox_draws``, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    p = load_npz(os.path.join(REPO, "experiment", "model_seed42.npz"))
    ws, bs = ef.stack_weights(p.decoders)
    rng = np.random.default_rng(0)
    T, B, S = 67, 13, mc_samples
    g = torch.as_tensor(rng.normal(size=(T, B, 2)).astype(np.float32) * 2,
                        device="cuda")
    ct = torch.as_tensor(rng.uniform(0.5, 2, B).astype(np.float32),
                         device="cuda")
    num_active = torch.as_tensor(rng.integers(1, 11, B), device="cuda")
    d1, d2 = mc.sample_decoder_indices(
        torch.Generator(device="cuda").manual_seed(5), T, B, 10, S, num_active)

    def close(e, e_p, d, d_p):
        torch.testing.assert_close(e, e_p, rtol=1e-5, atol=0)
        err = ((d - d_p).abs() / d_p.abs().max()).flatten()
        assert float(err.median()) < 1e-4
        assert float(torch.quantile(err, 0.99)) < 1e-3

    close(mc.energy_mc_fwd(ws, bs, g, d1, d2, precision),
          mc.energy_mc_fwd_plain(ws, bs, g, d1, d2, precision),
          mc.energy_mc_bwd(ws, bs, g, d1, d2, ct, precision),
          mc.energy_mc_bwd_plain(ws, bs, g, d1, d2, ct, precision))
    seed, kmax = (1 << 40) + 3, num_active.float()
    e7 = mc.energy_mc_fwd_rng(ws, bs, g, seed, kmax, S, precision)
    d8 = mc.energy_mc_bwd_rng(ws, bs, g, seed, kmax, S, ct, precision)
    close(e7, mc.energy_mc_fwd_rng_plain(ws, bs, g, seed, kmax, S, precision),
          d8, mc.energy_mc_bwd_rng_plain(ws, bs, g, seed, kmax, S, ct,
                                         precision))
    p1, p2 = (d.contiguous() for d in mc.philox_draws(seed, S, T, B, kmax))
    assert torch.equal(e7, mc.energy_mc_fwd(ws, bs, g, p1, p2, precision))
    assert torch.equal(d8, mc.energy_mc_bwd(ws, bs, g, p1, p2, ct, precision))


def _mc_bwd_pair(mc, ws, bs, g, ct, S, kmax, seed, precision):
    """K6 on ``torch.randint``-style planes and K8 on in-kernel draws, each
    with its plain version and a repeat: ((k6, k6_plain), (k8, k8_plain))
    after checking the repeats bitwise and K8 = K6 on the philox planes."""
    T, B = g.shape[:2]
    d1, d2 = mc.sample_decoder_indices(
        torch.Generator(device="cuda").manual_seed(S), T, B, ws[0].shape[0],
        S, kmax.long())
    k6 = mc.energy_mc_bwd(ws, bs, g, d1, d2, ct, precision)
    k8 = mc.energy_mc_bwd_rng(ws, bs, g, seed, kmax, S, ct, precision)
    assert torch.equal(k6, mc.energy_mc_bwd(ws, bs, g, d1, d2, ct, precision))
    assert torch.equal(k8, mc.energy_mc_bwd_rng(ws, bs, g, seed, kmax, S, ct,
                                                precision))
    p1, p2 = (d.contiguous() for d in mc.philox_draws(seed, S, T, B, kmax))
    assert torch.equal(k8, mc.energy_mc_bwd(ws, bs, g, p1, p2, ct, precision))
    return ((k6, mc.energy_mc_bwd_plain(ws, bs, g, d1, d2, ct, precision)),
            (k8, mc.energy_mc_bwd_plain(ws, bs, g, p1, p2, ct, precision)))


def _assert_dgamma_close(d, d_p):
    err = ((d - d_p).abs() / d_p.abs().max()).flatten()
    assert bool(torch.isfinite(d).all())
    assert float(err.median()) < 1e-4
    assert float(torch.quantile(err, 0.99)) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 2, 3, 9, 16])
@pytest.mark.parametrize("X,D,M", [(50, 2, 10)] + [
    (x, d, m) for x in (7, 50, 64) for d in (1, 2, 4) for m in (1, 3)])
@pytest.mark.parametrize("precision", ["f32x3", "f32x2", "bfloat16"])
def test_mc_backward_on_tensor_cores_matches_plain_versions_on_gpu(
        precision, X, D, M, S):
    """K6 and K8 at the reduced rungs (the tensor-core pair mc_select_mma +
    mc_chain_mma of ``csrc/energy_mc.cu``) against their plain versions:
    the committed model (X, D, M = 50, 2, 10) and random decoders at the
    widths the production kernels take, T*B = 67*13 (a ragged last tile),
    mixed per-spline decoder counts, S up to two sweeps of draws; every
    call repeated bitwise, K8 = K6 on the planes of ``philox_draws``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    rng = np.random.default_rng(S)
    if (X, D, M) == (50, 2, 10):
        p = load_npz(os.path.join(REPO, "experiment", "model_seed42.npz"))
        ws, bs = ef.stack_weights(p.decoders)
    else:
        ws, bs = _random_decoders(rng, M, D, X, "cuda")
    T, B = 67, 13
    g = torch.as_tensor(rng.normal(size=(T, B, D)).astype(np.float32) * 2,
                        device="cuda")
    ct = torch.as_tensor(rng.uniform(0.5, 2, B).astype(np.float32),
                         device="cuda")
    kmax = torch.as_tensor(rng.integers(1, M + 1, B), device="cuda").float()
    ef.reset_launch_counts()
    for d, d_p in _mc_bwd_pair(mc, ws, bs, g, ct, S, kmax, (1 << 40) + S,
                               precision):
        _assert_dgamma_close(d, d_p)
    assert ef.LAUNCHES["energy_mc_bwd"] == 3
    assert ef.LAUNCHES["energy_mc_bwd_rng"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("S", [9, 12, 33])
@pytest.mark.parametrize("shape", ["production", "S2"])
@pytest.mark.parametrize("precision", ["float32", "f32x3", "f32x2",
                                       "bfloat16"])
def test_mc_kernels_take_more_samples_than_one_sweep_on_gpu(precision, shape,
                                                            S):
    """K5-K8 at more samples than one sweep of staged draws (8 on the CUDA
    cores, 32 on the tensor cores) on the committed model (the CUDA-core
    kernels at float32, the tensor-core pair at the reduced rungs) and on
    the generic decode (decoder S2, every rung): against their plain
    versions, repeated bitwise, K7/K8 = K5/K6 on the planes of
    ``philox_draws``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    if shape == "production":
        p = load_npz(os.path.join(REPO, "experiment", "model_seed42.npz"))
        ws, bs = ef.stack_weights(p.decoders)
    else:
        ws, bs = _shape_decoders(shape, "cuda")
    rng = np.random.default_rng(S)
    T, B, M = 67, 13, ws[0].shape[0]
    g = torch.as_tensor(rng.normal(size=(T, B, 2)).astype(np.float32) * 2,
                        device="cuda")
    ct = torch.as_tensor(rng.uniform(0.5, 2, B).astype(np.float32),
                         device="cuda")
    kmax = torch.as_tensor(rng.integers(1, M + 1, B), device="cuda").float()
    seed = (1 << 40) + S
    for d, d_p in _mc_bwd_pair(mc, ws, bs, g, ct, S, kmax, seed, precision):
        _assert_dgamma_close(d, d_p)
    p1, p2 = (d.contiguous() for d in mc.philox_draws(seed, S, T, B, kmax))
    e7 = mc.energy_mc_fwd_rng(ws, bs, g, seed, kmax, S, precision)
    assert torch.equal(e7, mc.energy_mc_fwd_rng(ws, bs, g, seed, kmax, S,
                                                precision))
    assert torch.equal(e7, mc.energy_mc_fwd(ws, bs, g, p1, p2, precision))
    torch.testing.assert_close(
        e7, mc.energy_mc_fwd_plain(ws, bs, g, p1, p2, precision), rtol=1e-5,
        atol=0)


@pytest.mark.gpu
def test_mc_fused_optimizes_at_twelve_samples_on_gpu():
    """``optimize_spline_batch`` at ``mc_fused`` with 12 samples runs on the
    card (the backward kernels once refused more than 8): K8 every step,
    K7 for the final energies, finite lengths, the curves move."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.config import (EnergyConfig,
                                                      GeodesicConfig)
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch)

    params = load_npz(os.path.join(REPO, "experiment", "model_seed42.npz"),
                      "cuda")
    art = load_spline_batch(os.path.join(
        REPO, "experiment", "splines_init_model_seed42",
        "spline_batch_init_entropy_20.npz"))
    steps = 5
    cfg = GeodesicConfig(steps=steps, lr=1e-3, lr_schedule="constant",
                         batch_size=200, energy=EnergyConfig(
                             num_t=256, mode="mc_fused", mc_samples=12,
                             kernel_precision="f32x2"))
    ef.reset_launch_counts()
    out = optimize_spline_batch(params, art, cfg=cfg, device="cuda",
                                log_every_chunk=False,
                                generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert ef.LAUNCHES["energy_mc_bwd_rng"] == steps
    assert ef.LAUNCHES["energy_mc_fwd_rng"] == 1
    assert np.isfinite(out.geodesic_length).all()
    assert not np.array_equal(out.omega_optimized, art.omega_init)


@pytest.mark.gpu
@pytest.mark.parametrize("m_loc,D,X", [(1, 2, 50), (3, 2, 50)] + [
    (m, d, x) for m in (1, 10, 16) for d in (1, 4) for x in (8, 50, 64)])
@pytest.mark.parametrize("precision", ["float32", "f32x3", "f32x2",
                                       "bfloat16"])
def test_stats_kernels_match_plain_versions_on_gpu(precision, m_loc, D, X):
    """K3 and K4 against their plain versions on the card, T*B = 67*13 (a
    ragged last tile), local weight rows of the second shard with mixed
    per-spline decoder counts: the committed model's decoders (m_loc 1, 3)
    and seeded random decoders at the edges of the tensor-core kernels'
    layout (D = 1, 4; X = 8, 50, 64: layer 3 pads X to 8, the chain to 16;
    M_loc up to 16, the JAX kernels' cap).  A second call of each is
    bitwise equal to the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

    rng = np.random.default_rng(0)
    if (D, X) == (2, 50) and m_loc in (1, 3):
        p = load_npz(os.path.join(REPO, "experiment", "model_seed42.npz"))
        ws, bs = ef.stack_weights(p.decoders)
        ws = [w[m_loc:2 * m_loc].contiguous() for w in ws]
        bs = [b[m_loc:2 * m_loc].contiguous() for b in bs]
        m_total = 10
    else:
        ws, bs = _random_decoders(rng, m_loc, D, X, "cuda")
        m_total = 2 * m_loc
    T, B = 67, 13

    def dev(x):
        return torch.as_tensor(x.astype(np.float32), device="cuda")

    g = dev(rng.normal(size=(T, B, D)) * 2)
    wmb = ef.active_weights_local(
        torch.as_tensor(rng.integers(1, m_total + 1, B)), m_total, m_loc, B,
        1, "cuda").contiguous()
    cts = [dev(rng.normal(size=s)) for s in ((T, B, X), (T, B, X), (T, B))]
    out = ef.stats_fwd(ws, bs, g, wmb, precision)
    ref = ef.stats_fwd_plain(ws, bs, g, wmb, precision)
    # x0, yb at the decoder outputs' scale, sq at its own (chip_smoke.py's
    # STATS_X_RTOL / STATS_SQ_RTOL and the reasons there)
    x_tol, sq_tol = (1e-2, 5e-2) if precision == "bfloat16" else (5e-5, 5e-4)
    x_scale = float(ref[0].abs().max())
    assert float((out[0] - ref[0]).abs().max()) <= x_tol * x_scale
    assert float((out[1] - ref[1]).abs().max()) <= x_tol * x_scale
    assert float((out[2] - ref[2]).abs().max()) <= sq_tol * max(
        float(ref[2].abs().max()), 1e-30)
    if m_loc == 1:
        assert not out[1].any() and not out[2].any()
    d = ef.stats_bwd(ws, bs, g, wmb, *cts, precision)
    d_p = ef.stats_bwd_plain(ws, bs, g, wmb, *cts, precision)
    err = ((d - d_p).abs() / d_p.abs().max()).flatten()
    assert float(err.median()) < 1e-4
    assert float(torch.quantile(err, 0.99)) < 1e-3
    again = ef.stats_fwd(ws, bs, g, wmb, precision)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert torch.equal(d, ef.stats_bwd(ws, bs, g, wmb, *cts, precision))


@pytest.mark.gpu
@pytest.mark.parametrize("T,B", [(200, 13), (2000, 13), (2000, 300)])
@pytest.mark.parametrize("precision", ["float32", "f32x3", "f32x2",
                                       "bfloat16"])
def test_transposed_kernels_match_plain_versions_on_gpu(precision, T, B):
    """K9 and K10 against their plain versions on the card, M = 10, a
    ragged group of four splines at B = 13; on 132 SMs (200, 13) gives
    one-chunk spans, (2000, 13) spans of two chunks (a carry), (2000, 300)
    spans of nine chunks, 525 work items over the blocks in a stride."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops._research import (
        energy_fused_t as eft)

    p = load_npz(os.path.join(REPO, "experiment", "model_seed42.npz"))
    ws, bs = ef.stack_weights(p.decoders)
    rng = np.random.default_rng(0)
    g = torch.as_tensor(rng.normal(size=(T, B, 2)).astype(np.float32) * 2,
                        device="cuda")
    ct = torch.as_tensor(rng.uniform(0.5, 2, B).astype(np.float32),
                         device="cuda")
    e = eft.energy_t_fwd(ws, bs, g, precision)
    e_p = eft.energy_t_fwd_plain(ws, bs, g, precision)
    torch.testing.assert_close(e, e_p, rtol=1e-5, atol=0)
    d = eft.energy_t_bwd(ws, bs, g, ct, precision)
    d_p = eft.energy_t_bwd_plain(ws, bs, g, ct, precision)
    err = ((d - d_p).abs() / d_p.abs().max()).flatten()
    assert float(err.median()) < 1e-4
    assert float(torch.quantile(err, 0.99)) < 1e-3
    assert torch.equal(e, eft.energy_t_fwd(ws, bs, g, precision))
    assert torch.equal(d, eft.energy_t_bwd(ws, bs, g, ct, precision))


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,M,D,X", [
    (2000, 200, 10, 2, 50),   # the production chunk, the committed model
    (300, 3, 10, 2, 50),      # T - 1 a multiple of neither tile
    (2, 3, 10, 2, 50),
    (67, 1, 1, 1, 8),
    (129, 3, 16, 3, 64),
    (40, 3, 3, 4, 50),
    (128, 1, 16, 1, 64),
    (255, 3, 10, 4, 8),
])
def test_fwd_f32_kernels_match_plain_versions_on_gpu(T, B, M, D, X):
    """The float32 forward kernels on the CUDA cores (K1's k1_fwd_fma, K5/
    K7's selective-decode mc_fwd_fma over ``csrc/decode_f32.cuh``) against
    their plain versions at rtol 1e-5: the committed model on the
    production chunk and random decoders at the widths they take, per-spline
    decoder counts 1, 3 and M in turn, S = 1, 2, 3, 12, 16 on both draw
    routes; every call repeated bitwise, K7 = K5 on the planes of
    ``philox_draws``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    rng = np.random.default_rng([T, B, M, D, X])
    if (T, B) == (2000, 200):
        p = load_npz(os.path.join(REPO, "experiment", "model_seed42.npz"))
        ws, bs = ef.stack_weights(p.decoders)
    else:
        ws, bs = _random_decoders(rng, M, D, X, "cuda")
    g = torch.as_tensor(rng.normal(size=(T, B, D)).astype(np.float32) * 2,
                        device="cuda")
    counts = torch.as_tensor([min((1, 3, M)[b % 3], M) for b in range(B)],
                             device="cuda")
    wmb = ef.active_weights(counts, M, B, "cuda").contiguous()
    e1 = ef.energy_fwd(ws, bs, g, wmb, "float32")
    torch.testing.assert_close(
        e1, ef.energy_fwd_plain(ws, bs, g, wmb, "float32"), rtol=1e-5, atol=0)
    assert torch.equal(e1, ef.energy_fwd(ws, bs, g, wmb, "float32"))
    kmax = counts.float()
    for S in (1, 2, 3, 12, 16):
        d1, d2 = mc.sample_decoder_indices(
            torch.Generator(device="cuda").manual_seed(S), T, B, M, S, counts)
        e5 = mc.energy_mc_fwd(ws, bs, g, d1, d2, "float32")
        torch.testing.assert_close(
            e5, mc.energy_mc_fwd_plain(ws, bs, g, d1, d2, "float32"),
            rtol=1e-5, atol=0)
        assert torch.equal(e5, mc.energy_mc_fwd(ws, bs, g, d1, d2, "float32"))
        seed = (1 << 40) + S
        e7 = mc.energy_mc_fwd_rng(ws, bs, g, seed, kmax, S, "float32")
        p1, p2 = (d.contiguous() for d in mc.philox_draws(seed, S, T, B,
                                                          kmax))
        torch.testing.assert_close(
            e7, mc.energy_mc_fwd_plain(ws, bs, g, p1, p2, "float32"),
            rtol=1e-5, atol=0)
        assert torch.equal(e7, mc.energy_mc_fwd_rng(ws, bs, g, seed, kmax, S,
                                                    "float32"))
        assert torch.equal(e7, mc.energy_mc_fwd(ws, bs, g, p1, p2, "float32"))


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,M,D,X", [
    (2000, 200, 10, 2, 50),   # the production chunk, the committed model
    (300, 6, 10, 2, 50),      # T - 1 not a multiple of 31, B not of 4
    (70, 3, 1, 2, 50),        # one decoder
    (129, 5, 16, 4, 64),      # sixteen decoders, the widest latent and output
    (33, 1, 3, 1, 8),         # the narrowest output, one spline
])
@pytest.mark.parametrize("precision", ["f32x3", "f32x2", "bfloat16"])
def test_fwd_tiles_kernels_match_plain_versions_on_gpu(precision, T, B, M, D,
                                                       X):
    """The reduced-rung forward energies on the tensor cores (K1's
    k1_tiles_mma, K5/K7's mc_tiles_mma over K1's tiles) against their plain
    versions under chip_smoke's limits (E_RTOL; at bfloat16 E_RTOL_BF16_M1
    at M = 1 and otherwise the transposed test's 5e-5 for K1 and
    E_RTOL_MC_BF16 for K5/K7): per-spline decoder counts 1, 3 and M in turn,
    S = 1, 2, 3, 12 on both draw routes (12: three sweeps of samples); every
    call repeated bitwise, K7 = K5 on the planes of ``philox_draws``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    lim = _chip_smoke()
    rng = np.random.default_rng([T, B, M, D, X])
    if (T, B) == (2000, 200):
        p = load_npz(os.path.join(REPO, "experiment", "model_seed42.npz"))
        ws, bs = ef.stack_weights(p.decoders)
    else:
        ws, bs = _random_decoders(rng, M, D, X, "cuda")
    g = torch.as_tensor(rng.normal(size=(T, B, D)).astype(np.float32) * 2,
                        device="cuda")
    counts = torch.as_tensor([min((1, 3, M)[b % 3], M) for b in range(B)],
                             device="cuda")
    bf16 = precision == "bfloat16"
    e_rtol = (lim.E_RTOL if not bf16 else
              lim.E_RTOL_BF16_M1 if M == 1 else 5e-5)
    mc_rtol = (lim.E_RTOL if not bf16 else
               lim.E_RTOL_BF16_M1 if M == 1 else lim.E_RTOL_MC_BF16)
    for wmb in (ef.uniform_weights(M, B, "cuda"),
                ef.active_weights(counts, M, B, "cuda").contiguous()):
        e1 = ef.energy_fwd(ws, bs, g, wmb, precision)
        torch.testing.assert_close(
            e1, ef.energy_fwd_plain(ws, bs, g, wmb, precision), rtol=e_rtol,
            atol=0)
        assert torch.equal(e1, ef.energy_fwd(ws, bs, g, wmb, precision))
    kmax = counts.float()
    for S in (1, 2, 3, 12):
        d1, d2 = mc.sample_decoder_indices(
            torch.Generator(device="cuda").manual_seed(S), T, B, M, S, counts)
        e5 = mc.energy_mc_fwd(ws, bs, g, d1, d2, precision)
        torch.testing.assert_close(
            e5, mc.energy_mc_fwd_plain(ws, bs, g, d1, d2, precision),
            rtol=mc_rtol, atol=0)
        assert torch.equal(e5, mc.energy_mc_fwd(ws, bs, g, d1, d2, precision))
        seed = (1 << 40) + S
        e7 = mc.energy_mc_fwd_rng(ws, bs, g, seed, kmax, S, precision)
        p1, p2 = (d.contiguous() for d in mc.philox_draws(seed, S, T, B,
                                                          kmax))
        torch.testing.assert_close(
            e7, mc.energy_mc_fwd_plain(ws, bs, g, p1, p2, precision),
            rtol=mc_rtol, atol=0)
        assert torch.equal(e7, mc.energy_mc_fwd_rng(ws, bs, g, seed, kmax, S,
                                                    precision))
        assert torch.equal(e7, mc.energy_mc_fwd(ws, bs, g, p1, p2,
                                                precision))


def _chip_smoke():
    """chip_smoke.py as a module (its limits and float64_function)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_limits", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dgamma_errs(out, ref):
    err = ((out - ref).abs() / ref.abs().max()).flatten()
    return float(err.median()), float(torch.quantile(err, 0.99))


def _held_on_gpu(pairs):
    """pairs: (kind, kernel output, plain output): energies rtol 1e-5,
    dgamma median 1e-4 and 99th percentile 1e-3 of its largest element,
    the statistics at chip_smoke.py's STATS_X_RTOL / STATS_SQ_RTOL (the
    limits of the other-shapes test above; 5e-5 for energies and 1e-2 /
    5e-2 for statistics at bfloat16 come with its ``bf16`` kinds).  Two
    kinds follow chip_smoke.py's phase big: ``energy_f64`` (plain, float64
    function): within chip_smoke.BIG_BF16_E_RTOL of the plain version, and
    its largest and median errors from the float64 function within
    chip_smoke.K2_M1_FLOAT64 of the plain version's; ``dgamma_sliced``
    (slices' sum of the plain version, whole-X chain, float32 dgamma): the
    dgamma limits against the slices' sum, and its median and 99th
    percentile errors from the float32 dgamma within
    chip_smoke.SLICED_CHAIN of the whole-X chain's."""
    smoke = None
    for kind, out, ref in pairs:
        if kind in ("energy_f64", "dgamma_sliced") and smoke is None:
            smoke = _chip_smoke()
        if kind == "energy_f64":
            ref, truth = ref
            torch.testing.assert_close(out, ref, rtol=smoke.BIG_BF16_E_RTOL,
                                       atol=0)
            err_k = ((out.double() - truth).abs() / truth.abs())
            err_p = ((ref.double() - truth).abs() / truth.abs())
            for stat in (torch.max, torch.median):
                assert float(stat(err_k)) <= smoke.K2_M1_FLOAT64 * float(
                    stat(err_p)), (kind, float(stat(err_k)),
                                   float(stat(err_p)))
        elif kind in ("energy", "energy_bf16"):
            rtol = 5e-5 if kind == "energy_bf16" else 1e-5
            torch.testing.assert_close(out, ref, rtol=rtol, atol=0)
        elif kind in ("dgamma", "dgamma_sliced"):
            if kind == "dgamma_sliced":
                ref, whole, f32 = ref
                got_f32, whole_f32 = (_dgamma_errs(x, f32)
                                      for x in (out, whole))
                for a, b in zip(got_f32, whole_f32):
                    assert a <= smoke.SLICED_CHAIN * b, (kind, a, b)
            med, p99 = _dgamma_errs(out, ref)
            assert med < 1e-4, kind
            assert p99 < 1e-3, kind
        else:
            x_tol, sq_tol = (1e-2, 5e-2) if kind == "stats_bf16" else (5e-5, 5e-4)
            x_scale = float(ref[0].abs().max())
            assert float((out[0] - ref[0]).abs().max()) <= x_tol * x_scale
            assert float((out[1] - ref[1]).abs().max()) <= x_tol * x_scale
            assert float((out[2] - ref[2]).abs().max()) <= sq_tol * max(
                float(ref[2].abs().max()), 1e-30)


def _every_kernel(ws, bs, g, wmb, ct, cts, planes, seed, kmax, precision,
                  transposed, take=None, float64_energies=()):
    """(kind, kernel output, plain output) of K1-K8 (and K9/K10 where
    ``transposed``) on the card, every kernel call repeated and required
    bitwise equal; ``take``: the splines the plain versions run on (the
    kernel outputs are cut to them).  ``float64_energies``: the kernels
    among K1, K5, K7 whose energies are held as chip_smoke.py's phase big
    holds its BIG_BF16_E (kind ``energy_f64``); past MAX_X output columns
    at a reduced rung the dgamma of K2, K4, K6 and K8 are held as its
    sliced chains are (kind ``dgamma_sliced``)."""
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc
    from vae_latent_geometry_tpu_torch.ops._research import (
        energy_fused_t as eft)

    idx = take if take is not None else slice(None)
    cut = (lambda x: x) if take is None else (
        lambda x: x[:, take].contiguous() if x.dim() > 1 else x[take].contiguous())
    bf = precision == "bfloat16"
    d1, d2 = planes
    r1, r2 = mc.philox_draws(seed, d1.shape[0], g.shape[0], g.shape[1], kmax)

    def same(fn):
        out, again = fn(), fn()
        outs = out if isinstance(out, tuple) else (out,)
        agains = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(o, a) for o, a in zip(outs, agains))
        return out

    def on(out):
        if isinstance(out, tuple):
            return tuple(on(o) for o in out)
        return out[..., idx] if out.dim() == 1 else out[:, idx]

    gc, wc, cc = cut(g), cut(wmb), cut(ct)
    p1, p2 = (d[:, :, idx].contiguous() for d in (d1, d2))
    q1, q2 = (d[:, :, idx].contiguous() for d in (r1, r2))
    ctc = [cut(c) for c in cts]
    sliced = precision != "float32" and len(ef.x_slices(ws, bs)) > 1

    def dgamma(out, plain):
        """plain(w, b, c0, c1, precision): the kernel's plain version on
        decoder (w, b), K4's cotangents cut to output columns c0..c1."""
        X = ws[-1].shape[-1]
        if not sliced:
            return ("dgamma", out, plain(ws, bs, 0, X, precision))
        return ("dgamma_sliced", out, (
            ef.sum_slices(ws, bs, lambda w, b, c0, c1: plain(
                w, b, c0, c1, precision)),
            plain(ws, bs, 0, X, precision), plain(ws, bs, 0, X, "float32")))

    def cols(x, c0, c1):
        return x[..., c0:c1].contiguous()

    e_kind = "energy_bf16" if bf else "energy"
    out = [
        (e_kind, on(same(lambda: ef.energy_fwd(ws, bs, g, wmb, precision))),
         ef.energy_fwd_plain(ws, bs, gc, wc, precision)),
        dgamma(on(same(lambda: ef.energy_bwd(ws, bs, g, wmb, ct, precision))),
               lambda w, b, c0, c1, p: ef.energy_bwd_plain(w, b, gc, wc, cc,
                                                           p)),
        ("stats_bf16" if bf else "stats",
         on(same(lambda: ef.stats_fwd(ws, bs, g, wmb, precision))),
         ef.stats_fwd_plain(ws, bs, gc, wc, precision)),
        dgamma(on(same(lambda: ef.stats_bwd(ws, bs, g, wmb, *cts,
                                            precision))),
               lambda w, b, c0, c1, p: ef.stats_bwd_plain(
                   w, b, gc, wc, cols(ctc[0], c0, c1), cols(ctc[1], c0, c1),
                   ctc[2], p)),
        (e_kind, on(same(lambda: mc.energy_mc_fwd(ws, bs, g, d1, d2,
                                                  precision))),
         mc.energy_mc_fwd_plain(ws, bs, gc, p1, p2, precision)),
        dgamma(on(same(lambda: mc.energy_mc_bwd(ws, bs, g, d1, d2, ct,
                                                precision))),
               lambda w, b, c0, c1, p: mc.energy_mc_bwd_plain(
                   w, b, gc, p1, p2, cc, p)),
        (e_kind, on(same(lambda: mc.energy_mc_fwd_rng(
            ws, bs, g, seed, kmax, d1.shape[0], precision))),
         mc.energy_mc_fwd_plain(ws, bs, gc, q1, q2, precision)),
        dgamma(on(same(lambda: mc.energy_mc_bwd_rng(
            ws, bs, g, seed, kmax, d1.shape[0], ct, precision))),
               lambda w, b, c0, c1, p: mc.energy_mc_bwd_plain(
                   w, b, gc, q1, q2, cc, p)),
    ]
    if float64_energies:
        f64 = _chip_smoke().float64_function
        truths = {"K1": (0, lambda: f64(ef.energy_fwd_plain, ws, bs, gc,
                                        wc)),
                  "K5": (4, lambda: f64(mc.energy_mc_fwd_plain, ws, bs, gc,
                                        p1, p2)),
                  "K7": (6, lambda: f64(mc.energy_mc_fwd_plain, ws, bs, gc,
                                        q1, q2))}
        for name in float64_energies:
            i, truth = truths[name]
            out[i] = ("energy_f64", out[i][1], (out[i][2], truth()))
    if transposed:
        out += [
            (e_kind, on(same(lambda: eft.energy_t_fwd(ws, bs, g, precision))),
             eft.energy_t_fwd_plain(ws, bs, gc, precision)),
            ("dgamma", on(same(lambda: eft.energy_t_bwd(ws, bs, g, ct,
                                                        precision))),
             eft.energy_t_bwd_plain(ws, bs, gc, cc, precision)),
        ]
    return out


# D = 5, a 1024-unit layer, 7 layers, X = 200 (tests/test_torch_big_shapes.py)
BIG = (5, 1024, 24, 24, 24, 24, 24, 200)


def _seeded_decoders(dims, M, seed, device):
    rng = np.random.default_rng(seed)
    layers = [((rng.normal(size=(M, i, o)) / np.sqrt(i)).astype(np.float32),
               (0.1 * rng.normal(size=(M, o))).astype(np.float32))
              for i, o in zip(dims[:-1], dims[1:])]
    return ([torch.as_tensor(w, device=device) for w, _ in layers],
            [torch.as_tensor(b, device=device) for _, b in layers])


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [BIG, (2, 1024, 64, 50)],
                         ids=["big", "wide3"])
@pytest.mark.parametrize("precision", ["float32", "f32x3", "f32x2",
                                       "bfloat16"])
def test_every_kernel_matches_its_plain_version_on_big_shapes_on_gpu(
        precision, dims):
    """K1-K8 at the shapes past the former cap (X = 200 in two column
    slices, D = 5, a 1024-unit layer, 7 layers) and K1-K10 at a 3-layer
    decoder with a 1024-unit layer (the transposed op takes only 3 layers,
    D <= 2), against their plain versions under the other-shapes test's
    limits; T = 64, B = 13, mixed decoder counts, every call repeated
    bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    M, T, B = 3, 64, 13
    ws, bs = _seeded_decoders(dims, M, 7, "cuda")
    rng = np.random.default_rng(2)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device="cuda")

    g = dev(rng.normal(size=(T, B, dims[0])))
    ct = dev(rng.uniform(0.5, 2, B))
    counts = torch.as_tensor(rng.integers(1, M + 1, B))
    wmb = ef.active_weights(counts, M, B, "cuda").contiguous()
    X = dims[-1]
    cts = [dev(rng.normal(size=s)) for s in ((T, B, X), (T, B, X), (T, B))]
    planes = mc.sample_decoder_indices(
        torch.Generator(device="cuda").manual_seed(5), T, B, M, 2,
        counts.to("cuda"))
    kmax = torch.full((B,), float(M), device="cuda")
    ef.reset_launch_counts()
    # at bfloat16 the kernels' and the plain versions' bf16 rounding flips
    # compound over the seven layers: K1 and K7 read past 5e-5 there and are
    # held as chip_smoke.py's phase big holds its BIG_BF16_E (the same
    # decoders and inputs)
    f64 = ("K1", "K7") if precision == "bfloat16" and len(dims) > 4 else ()
    pairs = _every_kernel(ws, bs, g, wmb, ct, cts, planes, (1 << 40) + 3,
                          kmax, precision, len(dims) == 4,
                          float64_energies=f64)
    # the big decoder's X = 200 runs in two column slices per call
    assert ef.LAUNCHES["energy_fwd"] == 2 * (2 if X > 128 else 1)
    _held_on_gpu(pairs)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["float32", "f32x2"])
def test_every_kernel_takes_the_whole_matrix_on_gpu(precision):
    """T = 2000, B = 8,778 (the 133-class matrix as one chunk: past the
    32-bit index at 128-unit layers, two launches per call), the committed
    model: every kernel K1-K10 against its plain version on splines 0,
    4,000, 8,388 and 8,777 (the MC planes cut to them; K7/K8 through the
    planes of ``philox_draws``), every call repeated bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

    T, B, M = 2000, 8778, 10
    p = load_npz(os.path.join(REPO, "experiment", "model_seed42.npz"))
    ws, bs = ef.stack_weights(p.decoders)
    assert len(ef.spline_ranges(T, B, [2, 128, 128, 50])) == 2
    rng = np.random.default_rng(4)
    t = torch.linspace(0, 1, T, device="cuda")[:, None, None]
    a, b = (torch.as_tensor(rng.normal(size=(1, B, 2)).astype(np.float32) * 2,
                            device="cuda") for _ in range(2))
    g = ((1 - t) * a + t * b + 0.2 * torch.sin(6 * t + a)).contiguous()
    ct = torch.as_tensor(rng.uniform(0.5, 2, B).astype(np.float32),
                         device="cuda")
    wmb = ef.uniform_weights(M, B, "cuda")
    cts = [torch.randn(s, generator=torch.Generator(device="cuda")
                       .manual_seed(i), device="cuda")
           for i, s in enumerate(((T, B, 50), (T, B, 50), (T, B)))]
    planes = mc.sample_decoder_indices(
        torch.Generator(device="cuda").manual_seed(5), T, B, M, 2, None)
    kmax = torch.full((B,), float(M), device="cuda")
    take = torch.tensor([0, 4000, 8388, 8777], device="cuda")
    _held_on_gpu(_every_kernel(ws, bs, g, wmb, ct, cts, planes, 99, kmax,
                               precision, True, take))


@pytest.mark.gpu
@pytest.mark.parametrize("T,B,M,D,X", [
    (200, 13, 1, 1, 8),       # one decoder, the narrowest output
    (200, 7, 3, 2, 50),       # T - 1 a multiple of neither 31 nor 32
    (2000, 13, 10, 2, 64),    # spans of several tiles, the widest output
    (96, 5, 16, 1, 50),       # sixteen decoders, a ragged spline group
    (400, 201, 10, 2, 50),    # more work items than blocks
])
@pytest.mark.parametrize("precision", ["float32", "f32x3", "f32x2",
                                       "bfloat16"])
def test_transposed_kernels_on_the_tensor_cores_on_gpu(precision, T, B, M, D,
                                                       X):
    """K9 and K10 on the production decoder shape (D <= 2 -> 128 -> 128 ->
    X <= 64): at the reduced rungs the tensor-core kernels (K1's
    k1_tiles_mma, k10_mma), at float32 K1's k1_fwd_fma and k10_dgamma<0>,
    against their
    plain versions under the transposed test's limits, every call repeated
    bitwise; seeded random decoders and points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from vae_latent_geometry_tpu_torch.ops._research import (
        energy_fused_t as eft)

    ws, bs = _seeded_decoders((D, 128, 128, X), M, 3 + M, "cuda")
    rng = np.random.default_rng(T + B)
    g = torch.as_tensor(rng.normal(size=(T, B, D)).astype(np.float32) * 1.5,
                        device="cuda")
    ct = torch.as_tensor(rng.uniform(0.5, 2, B).astype(np.float32),
                         device="cuda")
    e = eft.energy_t_fwd(ws, bs, g, precision)
    e_p = eft.energy_t_fwd_plain(ws, bs, g, precision)
    rtol = 5e-5 if precision == "bfloat16" else 1e-5
    torch.testing.assert_close(e, e_p, rtol=rtol, atol=0)
    d = eft.energy_t_bwd(ws, bs, g, ct, precision)
    d_p = eft.energy_t_bwd_plain(ws, bs, g, ct, precision)
    err = ((d - d_p).abs() / d_p.abs().max()).flatten()
    assert float(err.median()) < 1e-4
    assert float(torch.quantile(err, 0.99)) < 1e-3
    assert torch.equal(e, eft.energy_t_fwd(ws, bs, g, precision))
    assert torch.equal(d, eft.energy_t_bwd(ws, bs, g, ct, precision))
