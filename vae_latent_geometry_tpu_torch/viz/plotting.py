"""Figures of the pipeline (``vae_latent_geometry_tpu.viz.plotting``): the
same functions, file names and figures, drawn with matplotlib's Agg
backend.  The heavy parts run on the device: the Gaussian KDE of the
latents over a grid (the reference loops over all 23,822 latents per grid
point, ``src/plotting.py:58-62``), the pullback metrics J^T J along a path,
and the ensemble's disagreement over a grid.

- latent density + splines (KDE background as log1p(1/(density+eps)),
  dashed init and solid optimized curves), and the 'Geodesics in Latent
  Space' illustration;
- metric ellipses of the pullback metric along a path;
- latents + selected representatives; initialized splines; init +
  optimized overlay (first 10 splines);
- ensemble-uncertainty map (``src/plot_latents.py``);
- loss curves, CoV-vs-decoders curves, the CoV histogram, distance-matrix
  heatmaps.

matplotlib is imported when a figure is drawn, not with this module: the
device functions (``kde_density``, ``pullback_metrics``) need only torch.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Optional, Sequence

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.device import resolve_device


def matplotlib_available() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    """matplotlib.pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _colorbar_axis(ax, size: str, pad: float):
    from mpl_toolkits.axes_grid1 import make_axes_locatable

    return make_axes_locatable(ax).append_axes("right", size=size, pad=pad)


def _ensure_dir(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def _get_cmap(name: str, n: int):
    """A named colormap resampled to ``n`` colors."""
    import matplotlib

    return matplotlib.colormaps[name].resampled(n)


def _square_limits(latents: np.ndarray, margin_frac: float = 0.1):
    x, y = latents[:, 0], latents[:, 1]
    span = max(x.max() - x.min(), y.max() - y.min())
    cx, cy = (x.max() + x.min()) / 2, (y.max() + y.min()) / 2
    half = span / 2 + margin_frac * span
    return (cx - half, cx + half), (cy - half, cy + half)


def kde_density(latents: np.ndarray, grid: np.ndarray, sigma: float = 0.3,
                chunk: int = 4096, device=None) -> np.ndarray:
    """Gaussian KDE of ``latents`` (N, 2) at ``grid`` (G, 2) -> (G,), as
    chunks of grid points against every latent on ``device`` (default
    cuda)."""
    dev = resolve_device(device)
    lat = torch.as_tensor(np.asarray(latents, np.float32), device=dev)
    g_all = torch.as_tensor(np.asarray(grid, np.float32), device=dev)
    parts = []
    with torch.no_grad():
        for i in range(0, len(g_all), chunk):
            g = g_all[i:i + chunk]
            d2 = torch.sum((g[:, None, :] - lat[None, :, :]) ** 2, dim=-1)
            parts.append(torch.sum(torch.exp(-0.5 * d2 / sigma ** 2), dim=1))
    out = torch.cat(parts).cpu().numpy()
    return out / (len(latents) * 2 * np.pi * sigma ** 2)


def _density_background(latents, res, sigma, eps, device):
    """(log1p(1/(density + eps)) on a res x res grid, xlim, ylim)."""
    xlim, ylim = _square_limits(latents)
    xi, yi = np.mgrid[xlim[0]:xlim[1]:res * 1j, ylim[0]:ylim[1]:res * 1j]
    grid = np.stack([xi.ravel(), yi.ravel()], axis=-1).astype(np.float32)
    density = kde_density(latents, grid, sigma, device=device)
    return np.log1p(1.0 / (density + eps)).reshape(xi.shape), xlim, ylim


def _spline_points(omega, a, b, basis, n_poly: int, n: int = 300
                   ) -> np.ndarray:
    """(n, D) points of one spline, on the CPU."""
    from vae_latent_geometry_tpu_torch.geometry.spline import (
        design_matrix,
        eval_spline_design,
        t_grid,
    )

    t = t_grid(n)
    phi = design_matrix(t, basis, n_poly)
    g = eval_spline_design(
        torch.as_tensor(np.asarray(omega, np.float32))[None],
        torch.as_tensor(np.asarray(a, np.float32))[None],
        torch.as_tensor(np.asarray(b, np.float32))[None], phi, t)
    return g[:, 0, :].numpy()


def _draw_splines(ax, art, max_splines, init_kw, opt_kw, colors):
    for i in range(min(len(art.a), max_splines)):
        if not art.valid[i]:
            continue
        z = _spline_points(art.omega_init[i], art.a[i], art.b[i], art.basis,
                           art.n_poly)
        ax.plot(z[:, 0], z[:, 1], "--", c=colors(i), **init_kw)
        if art.omega_optimized is not None:
            z = _spline_points(art.omega_optimized[i], art.a[i], art.b[i],
                               art.basis, art.n_poly)
            ax.plot(z[:, 0], z[:, 1], "-", c=colors(i), **opt_kw)


def plot_latent_density_with_splines(latents, labels, art, save_path: str,
                                     res: int = 300, seed=None,
                                     sigma: float = 0.3, eps: float = 1e-4,
                                     max_splines: int = 10,
                                     device=None) -> None:
    """Density background + init (dashed) / optimized (solid) overlays."""
    plt = _plt()
    _ensure_dir(save_path)
    log_metric, xlim, ylim = _density_background(latents, res, sigma, eps,
                                                 device)
    fig, ax = plt.subplots(figsize=(8, 8))
    im = ax.imshow(log_metric.T, origin="lower", extent=(*xlim, *ylim),
                   cmap="copper", alpha=0.8)
    try:
        import seaborn as sns

        sns.scatterplot(x=latents[:, 0], y=latents[:, 1], hue=labels,
                        palette="tab20", s=4, alpha=0.4, legend=False, ax=ax)
    except Exception:
        ax.scatter(latents[:, 0], latents[:, 1], s=2, alpha=0.4)
    _draw_splines(ax, art, max_splines, {"lw": 1.2, "alpha": 0.6},
                  {"lw": 2.0},
                  _get_cmap("tab10", max(min(len(art.a), max_splines), 1)))
    ax.set_xlim(xlim); ax.set_ylim(ylim)
    ax.set_aspect("equal", adjustable="box")
    ax.set_xlabel("z1"); ax.set_ylabel("z2")
    ax.set_title(f"Geodesics in latent space (seed {seed})")
    fig.colorbar(im, cax=_colorbar_axis(ax, "5%", 0.1),
                 label="log(1 + 1/(density+eps))")
    plt.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def plot_metric_ellipses(ax, z_path: np.ndarray, metrics: np.ndarray,
                         every: int = 20, scale: float = 0.2) -> None:
    """Ellipse patches of the 2x2 pullback metric along a path."""
    from matplotlib import patches

    for z, G in zip(z_path[::every], metrics[::every]):
        eigvals, eigvecs = np.linalg.eigh(G)
        width, height = scale * np.sqrt(np.maximum(eigvals, 0))
        angle = np.degrees(np.arctan2(eigvecs[1, 0], eigvecs[0, 0]))
        ax.add_patch(patches.Ellipse(xy=z, width=width, height=height,
                                     angle=angle, edgecolor="black",
                                     facecolor="none", lw=1))


def pullback_metrics(decoder_params, z_path: np.ndarray) -> np.ndarray:
    """G(z) = J(z)^T J(z) along a path (P, D) -> (P, D, D): one vmapped
    forward-mode Jacobian of the decoder mean on the device of its
    parameters (the reference loops over rows with autograd,
    ``src/old_/jacobian_smgs.py:4-8``)."""
    from vae_latent_geometry_tpu_torch.models import nets

    dev = decoder_params["layers"][0]["w"].device
    z = torch.as_tensor(np.asarray(z_path, np.float32), device=dev)
    jac = torch.func.vmap(torch.func.jacfwd(
        lambda v: nets.decoder_apply(decoder_params, v[None])[0]))
    with torch.no_grad():
        J = jac(z)                                   # (P, X, D)
        return torch.einsum("pxi,pxj->pij", J, J).cpu().numpy()


def plot_latents_with_selected(latents, representatives,
                               save_path: str) -> None:
    plt = _plt()
    _ensure_dir(save_path)
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.scatter(latents[:, 0], latents[:, 1], s=5, alpha=0.4, label="All data")
    sel = latents[[r["index"] for r in representatives]]
    ax.scatter(sel[:, 0], sel[:, 1], c="red", s=30, label="Selected",
               edgecolors="black")
    for i, (x, y) in enumerate(sel):
        ax.annotate(str(i), (x, y), fontsize=8, xytext=(3, 3),
                    textcoords="offset points")
    ax.set_aspect("equal"); ax.legend()
    ax.set_title("Latent space with selected representatives")
    plt.tight_layout(); plt.savefig(save_path, dpi=300); plt.close(fig)


def plot_initialized_splines(latents, art, save_path: str) -> None:
    plt = _plt()
    from matplotlib import cm

    _ensure_dir(save_path)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(latents[:, 0], latents[:, 1], s=2, color="lightgray", alpha=0.5)
    colors = cm.tab20(np.linspace(0, 1, max(len(art.a), 1)))
    for i in range(len(art.a)):
        if not art.valid[i]:
            continue
        z = _spline_points(art.omega_init[i], art.a[i], art.b[i], art.basis,
                           art.n_poly)
        ax.plot(z[:, 0], z[:, 1], "-", color=colors[i % len(colors)], lw=1.5)
    if art.representatives:
        rep_z = latents[[r["index"] for r in art.representatives]]
        ax.scatter(rep_z[:, 0], rep_z[:, 1], s=20, color="black", zorder=3)
    ax.set_title("Initialized geodesic splines")
    ax.axis("equal"); ax.grid(True)
    plt.tight_layout(); plt.savefig(save_path, dpi=300); plt.close(fig)


def plot_initial_and_optimized_splines(latents, art, save_path: str,
                                       max_splines: int = 10) -> None:
    plt = _plt()
    from matplotlib import cm

    _ensure_dir(save_path)
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.scatter(latents[:, 0], latents[:, 1], s=2, color="lightgray", alpha=0.5)
    n = min(len(art.a), max_splines)
    colors = cm.tab10(np.linspace(0, 1, max(n, 1)))
    _draw_splines(ax, art, max_splines, {"lw": 1.0, "alpha": 0.6},
                  {"lw": 2.0}, lambda i: colors[i % len(colors)])
    ax.set_aspect("equal")
    ax.set_title("Initial (dashed) and optimized (solid) geodesic splines")
    plt.tight_layout(); plt.savefig(save_path, dpi=300); plt.close(fig)


def plot_uncertainty_map(params, latents, save_path: str,
                         colors: Optional[np.ndarray] = None,
                         resolution: int = 100, padding: float = 0.5) -> None:
    """Ensemble-disagreement heatmap over latent space + latent scatter
    (reference ``src/plot_latents.py:52-110``); the decoders run on the
    device of ``params``."""
    from vae_latent_geometry_tpu_torch.models.evae import decoder_std

    plt = _plt()
    _ensure_dir(save_path)
    c1 = (latents[:, 0].min() + latents[:, 0].max()) / 2
    c2 = (latents[:, 1].min() + latents[:, 1].max()) / 2
    half = max(np.ptp(latents[:, 0]), np.ptp(latents[:, 1])) / 2 + padding
    zs1 = np.linspace(c1 - half, c1 + half, resolution)
    zs2 = np.linspace(c2 - half, c2 + half, resolution)
    Z1, Z2 = np.meshgrid(zs1, zs2, indexing="xy")
    grid = np.stack([Z1.ravel(), Z2.ravel()], axis=-1).astype(np.float32)
    dev = params.decoders["layers"][0]["w"].device
    with torch.no_grad():
        std = decoder_std(params.decoders,
                          torch.as_tensor(grid, device=dev)).cpu().numpy()
    unc = std.mean(axis=1).reshape(resolution, resolution)

    fig, ax = plt.subplots(figsize=(7, 7))
    cax = _colorbar_axis(ax, "5%", 0.05)
    pc = ax.pcolormesh(Z1, Z2, unc, cmap="viridis", shading="auto",
                       rasterized=True)
    plt.colorbar(pc, cax=cax, label="Decoder uncertainty (std)")
    ax.scatter(latents[:, 0], latents[:, 1],
               c=colors if colors is not None else "k", s=5, alpha=0.8,
               linewidth=0)
    ax.set_aspect("equal", adjustable="box")
    ax.set_xlabel("z1"); ax.set_ylabel("z2")
    ax.set_title("Latent space ensemble uncertainty")
    plt.tight_layout(); plt.savefig(save_path, dpi=300); plt.close(fig)


def plot_loss_curves(train_losses, val_losses, save_path: str) -> None:
    plt = _plt()
    _ensure_dir(save_path)
    fig = plt.figure(figsize=(8, 5))
    plt.plot(train_losses, label="Train")
    plt.plot(val_losses, label="Val")
    plt.xlabel("Epoch"); plt.ylabel("Neg ELBO"); plt.title("Training curve")
    plt.legend(); plt.grid(True); plt.tight_layout()
    plt.savefig(save_path); plt.close(fig)


def plot_cov_curves(cov_result, save_path: str) -> None:
    plt = _plt()
    _ensure_dir(save_path)
    ks = cov_result.decoder_counts
    y_geo = [cov_result.avg_cov_geodesic[k] for k in ks]
    fig = plt.figure(figsize=(8, 5))
    plt.plot(ks, y_geo, marker="o", label="Geodesic CoV")
    plt.plot(ks, [cov_result.avg_cov_euclidean] * len(ks), "--",
             label="Euclidean CoV")
    plt.xlabel("Number of decoders"); plt.xticks(ks)
    plt.ylabel("Average coefficient of variation")
    plt.title("CoV vs number of decoders")
    plt.legend(); plt.grid(True); plt.tight_layout()
    plt.savefig(save_path); plt.close(fig)


def plot_cov_hist(cov_values, save_path: str,
                  title: str = "Coefficient of Variation (CoV) Across Seeds",
                  bins: int = 30) -> None:
    """Per-pair CoV histogram with a KDE overlay scaled to counts (the
    reference's ``experiment/plots/cov_hist_euclidean_10.png``)."""
    plt = _plt()
    _ensure_dir(save_path)
    vals = np.asarray(cov_values, float)
    vals = vals[np.isfinite(vals)]
    fig, ax = plt.subplots(figsize=(8, 5))
    _, edges, _ = ax.hist(vals, bins=bins, color="#9f95d8",
                          edgecolor="black", alpha=0.85)
    if len(vals) > 1 and np.std(vals) > 0:
        from scipy.stats import gaussian_kde

        xs = np.linspace(vals.min(), vals.max(), 200)
        kde = gaussian_kde(vals)(xs)
        ax.plot(xs, kde * len(vals) * (edges[1] - edges[0]),
                color="#7b68ce", lw=2.5)
    ax.set_xlabel("CoV"); ax.set_ylabel("Frequency")
    ax.set_title(title)
    plt.tight_layout(); plt.savefig(save_path, dpi=300); plt.close(fig)


def plot_density_illustration(latents, art, save_path: str,
                              point_colors: Optional[np.ndarray] = None,
                              labels: Optional[Sequence] = None,
                              res: int = 300, seed=None, sigma: float = 0.3,
                              eps: float = 1e-4, max_splines: int = 10,
                              device=None) -> None:
    """'Geodesics in Latent Space' (reference
    ``src/plots/density_illustration_examples{seed}.png``): copper
    density-metric background, latents colored per class (hex colors when
    given), init (dashed) / optimized (solid) geodesics."""
    plt = _plt()
    _ensure_dir(save_path)
    log_metric, xlim, ylim = _density_background(latents, res, sigma, eps,
                                                 device)
    fig, ax = plt.subplots(figsize=(10, 9))
    im = ax.imshow(log_metric.T, origin="lower", extent=(*xlim, *ylim),
                   cmap="copper", alpha=0.9)
    if point_colors is not None:
        ax.scatter(latents[:, 0], latents[:, 1], c=point_colors, s=4,
                   alpha=0.5, linewidth=0.1, edgecolors="white")
    elif labels is not None:
        _, inv = np.unique(np.asarray(labels), return_inverse=True)
        ax.scatter(latents[:, 0], latents[:, 1], c=inv, cmap="tab20", s=4,
                   alpha=0.5, linewidth=0)
    else:
        ax.scatter(latents[:, 0], latents[:, 1], s=3, alpha=0.4, c="gray")
    _draw_splines(ax, art, max_splines, {"lw": 2.0, "alpha": 0.8},
                  {"lw": 3.0},
                  _get_cmap("tab10", max(min(len(art.a), max_splines), 1)))
    ax.set_xlim(xlim); ax.set_ylim(ylim)
    ax.set_aspect("equal", adjustable="box")
    ax.set_xlabel("z$_1$"); ax.set_ylabel("z$_2$")
    ax.set_title("Geodesics in Latent Space" if seed is None
                 else f"Geodesics in Latent Space (seed {seed})")
    fig.colorbar(im, cax=_colorbar_axis(ax, "4%", 0.1),
                 label="Density-based metric value log(G$_x$)")
    plt.savefig(save_path, dpi=300, bbox_inches="tight")
    plt.close(fig)


def plot_distance_matrix(mat: np.ndarray, labels: Sequence[str],
                         save_path: str, title: str = "") -> None:
    plt = _plt()
    _ensure_dir(save_path)
    fig = plt.figure(figsize=(10, 10))
    try:
        import seaborn as sns

        sns.heatmap(mat, square=True, xticklabels=labels, yticklabels=labels,
                    cmap="copper", cbar=False)
    except Exception:
        plt.imshow(mat, cmap="copper")
    plt.xticks(rotation=90, fontsize=4); plt.yticks(rotation=0, fontsize=4)
    plt.title(title); plt.xlabel("Cluster"); plt.ylabel("Cluster")
    plt.tight_layout(); plt.savefig(save_path, dpi=300); plt.close(fig)
