"""Typed configuration shared across all pipeline stages.

A copy of ``vae_latent_geometry_tpu.config`` with the same fields and
defaults, so a config built for one package means the same run in the
other (and a training run's config stamp is the same JSON in both).
``EnergyConfig.ep_axis`` names the axis of a ``parallel.mesh.Mesh`` that
the decoder ensemble is sharded over.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Ensemble-VAE architecture (reference ``src/train.py:16-85``)."""

    input_dim: int = 50
    latent_dim: int = 2
    num_decoders: int = 10
    encoder_hidden: Sequence[int] = (256, 128)
    decoder_hidden: Sequence[int] = (128, 128)
    decoder_sigma: float = 5.0
    beta: float = 1.0
    heteroscedastic: bool = False
    encoder_logstd_clamp: tuple[float, float] = (-4.0, 2.0)
    decoder_logstd_clamp: tuple[float, float] = (-2.0, 2.0)
    # The decoder family of scVI (scvi-tools ``DecoderSCVI``): "linear" is
    # the reference's output layer, "softmax" scVI's mean head
    # library_size * softmax(W h + b).  ``decoder_batchnorm``: an eval-mode
    # BatchNorm1d (running statistics, affine, ``batchnorm_eps``) after each
    # hidden layer's affine map, before its ReLU.  Port-only fields: at
    # their defaults :func:`to_dict` leaves them out, so a stamp or sidecar
    # of every other model is the JAX package's JSON.
    decoder_head: str = "linear"
    decoder_batchnorm: bool = False
    batchnorm_eps: float = 1e-3
    library_size: float = 1.0


# ModelConfig's fields that the JAX package's ModelConfig does not have
PORT_ONLY_FIELDS = ("decoder_head", "decoder_batchnorm", "batchnorm_eps",
                    "library_size")


@dataclass(frozen=True)
class SplineConfig:
    """Fixed-endpoint cubic-spline curve family."""

    n_poly: int = 4
    degree: int = 3  # cubic segments; basis columns K = n_poly + 1

    @property
    def n_coeff(self) -> int:
        return (self.degree + 1) * self.n_poly


@dataclass(frozen=True)
class EnergyConfig:
    """Curve-energy functional (reference ``src/optimize.py:38-75``)."""

    num_t: int = 2000            # quadrature samples along each curve
    mc_samples: int = 2          # M independent decoder-pair draws
    mode: str = "mc"
    endpoint_weight: float = 1000.0
    # Precision rung of the fused kernels on trajectory steps ("float32" |
    # "f32x3" | "f32x2" | "bfloat16"; ops/energy_fused.py).  Final energies
    # are always re-evaluated at "float32".
    kernel_precision: str = "f32x3"
    # mc_fused modes: make the decoder draws inside the kernels from a
    # per-step seed (True) or ship (S, T-1, B) index planes to them (False).
    mc_inkernel_rng: bool = True
    target_num_t: Optional[int] = None
    ep_axis: Optional[str] = None
    # Trajectory steps discard the energy value, so the fused modes launch
    # only the backward kernel there (gradients are identical: the backward
    # recomputes activations from the inputs).  History recording keeps the
    # value path.
    gradonly_traj: bool = True


@dataclass(frozen=True)
class GeodesicConfig:
    """Batched geodesic optimization (reference ``src/optimize.py:143-186``)."""

    steps: int = 1000
    lr: float = 1e-3
    batch_size: int = 200
    # "constant" (reference semantics) or "cosine" (linear warmup to ``lr``
    # over ``lr_warmup`` steps, cosine decay to ``lr_end`` by ``steps``).
    lr_schedule: str = "constant"
    lr_warmup: int = 20
    lr_end: float = 1e-5
    # Trajectory-only quadrature resolution (final energies use energy.num_t).
    traj_num_t: Optional[int] = None
    # Full-resolution polish phase after a ``traj_num_t`` coarse phase.
    polish_steps: int = 0
    polish_lr: float = 1e-3
    # Multi-phase ladder of (steps, num_t, lr_schedule, lr[, energy_mode])
    # entries; supersedes traj_num_t/polish_steps when set.
    phase_plan: Optional[Tuple[Tuple, ...]] = None
    # Energy mode of the exact final re-evaluation (None = energy.mode).
    final_energy_mode: Optional[str] = None
    energy: EnergyConfig = field(default_factory=EnergyConfig)
    spline: SplineConfig = field(default_factory=SplineConfig)
    patience: int = 500
    delta: float = 1e-6
    early_stop: bool = False


@dataclass(frozen=True)
class InitConfig:
    """Dijkstra spline initialization (reference ``src/init_splines_ensemble.py``)."""

    grid_points_per_axis: int = 200
    grid_margin: float = 0.1
    knn: int = 8
    use_entropy: bool = False
    max_path_len: int = 1024
    spline: SplineConfig = field(default_factory=SplineConfig)


@dataclass(frozen=True)
class TrainConfig:
    """VAE / EVAE training (reference ``src/train.py:91-179``)."""

    epochs: int = 200
    batch_size: int = 64
    lr: float = 1e-3
    seed: int = 42
    val_ratio: float = 0.1
    beta_warmup_epochs: int = 0
    lr_step_size: int = 0
    lr_gamma: float = 0.5


def to_dict(cfg: Any) -> dict:
    """The config as a dict; a ModelConfig without the port-only fields
    that are at their defaults (:data:`PORT_ONLY_FIELDS`)."""
    out = dataclasses.asdict(cfg)
    if isinstance(cfg, ModelConfig):
        default = ModelConfig()
        for name in PORT_ONLY_FIELDS:
            if getattr(cfg, name) == getattr(default, name):
                del out[name]
    return out


def _merge(cls, base: Any, overrides: dict):
    known = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in overrides.items():
        if k not in known:
            raise KeyError(f"Unknown config field {k!r} for {cls.__name__}")
        cur = getattr(base, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kwargs[k] = _merge(type(cur), cur, v)
        else:
            kwargs[k] = v
    return dataclasses.replace(base, **kwargs)


def from_dict(cls, overrides: Optional[dict] = None):
    """Build a config of type ``cls`` from defaults plus nested overrides."""
    base = cls()
    if not overrides:
        return base
    return _merge(cls, base, overrides)


def from_yaml(path: str):
    """Load (ModelConfig, TrainConfig) from a YAML file (this framework's
    nested layout or the reference's ``configs/config.yaml`` schema)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    vae = dict(raw.get("vae") or raw.get("model") or {})
    vae.pop("num_decoders_comment", None)
    model_over = {k: v for k, v in vae.items()
                  if k in {f.name for f in dataclasses.fields(ModelConfig)}}
    training = dict(raw.get("training") or raw.get("train") or {})
    train_over = {k: v for k, v in training.items()
                  if k in {f.name for f in dataclasses.fields(TrainConfig)}}
    return from_dict(ModelConfig, model_over), from_dict(TrainConfig, train_over)
