"""Configuration schema and YAML loader for the PyTorch port.

The port keeps its own copy of the dataclasses from `tdgp/config.py` that a
served generator reads, with the same field names and defaults, so that an
`experiment_config.yaml` written by a JAX training run loads unchanged.
Sections of that file that serving does not read (discriminator, loss,
training, ...) are listed in `_UNSERVED_SECTIONS` and passed over.

The loader mirrors `tdgp/infra/experiment.py`: a strict dataclass overlay,
dotted-key overrides, then `finalize_config` for the derived values.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import yaml


# --------------------------------------------------------------- camera

@dataclass(frozen=True)
class Dist:
    dist: str = 'uniform'
    mean: float = 0.0
    std: float = 0.0
    min: float = 0.0
    max: float = 0.0


@dataclass(frozen=True)
class AnglesDist:
    dist: str = 'uniform'
    yaw: Dist = Dist()
    pitch: Dist = Dist()


@dataclass(frozen=True)
class OriginCfg:
    radius: Dist = Dist(dist='normal', mean=1.0, std=0.0)
    angles: AnglesDist = AnglesDist(
        dist='uniform',
        yaw=Dist(dist='uniform', min=-1.57, max=1.57),
        pitch=Dist(dist='uniform', min=0.785398163, max=2.35619449),
    )


@dataclass(frozen=True)
class LookAtCfg:
    radius: Dist = Dist(dist='uniform', min=0.0, max=0.2)
    angles: AnglesDist = AnglesDist(
        dist='spherical_uniform',
        yaw=Dist(dist='spherical_uniform', min=-3.14159265, max=3.14159265),
        pitch=Dist(dist='spherical_uniform', min=0.0, max=3.14159265),
    )


@dataclass(frozen=True)
class RayCfg:
    start: float = 0.75
    end: float = 1.25


@dataclass(frozen=True)
class CameraConfig:
    ray: RayCfg = RayCfg()
    fov: Dist = Dist(dist='uniform', min=10.0, max=45.0)
    origin: OriginCfg = OriginCfg()
    look_at: LookAtCfg = LookAtCfg()
    cube_scale: float = 0.5
    validate_viewing_frustum: bool = False


# --------------------------------------------------------------- generator

@dataclass(frozen=True)
class TriPlaneMLPCfg:
    n_layers: int = 2
    hid_dim: int = 64


@dataclass(frozen=True)
class TriPlaneCfg:
    res: int = 512
    feat_dim: int = 32
    mlp: TriPlaneMLPCfg = TriPlaneMLPCfg()


@dataclass(frozen=True)
class DepthAdaptorCfg:
    enabled: bool = True
    kernel_size: int = 5
    hid_dim: int = 64
    num_hid_layers: int = 3
    out_strategy: str = 'random'
    selection_start_p: float = 0.1
    anneal_kimg: int = 10000
    near_plane_offset_max_fraction: float = 0.25
    near_plane_offset_bias: float = -3.0


@dataclass(frozen=True)
class AdjustCfg:
    angles: bool = True
    radius: bool = False
    fov: bool = True
    look_at: bool = True


@dataclass(frozen=True)
class EMDCfg:
    enabled: bool = True
    anneal_kimg: int = 10000
    num_samples: int = 64
    origin: float = 2.0
    radius: float = 0.0
    fov: float = 0.0001
    look_at: float = 0.0001


@dataclass(frozen=True)
class LipschitzCfg:
    enabled: bool = False
    angles: float = 0.0
    radius: float = 0.0
    fov: float = 0.0
    look_at: float = 0.0


@dataclass(frozen=True)
class CameraAdaptorCfg:
    enabled: bool = True
    residual: bool = False
    lr_multiplier: float = 0.1
    z_dim: int = 512
    c_dim: int = 0
    hid_dim: int = 256
    embed_dim: int = 16
    adjust: AdjustCfg = AdjustCfg()
    emd: EMDCfg = EMDCfg()
    lipschitz_weights: LipschitzCfg = LipschitzCfg()
    force_mean_weight: float = 10.0


@dataclass(frozen=True)
class PatchCfg:
    enabled: bool = True
    patch_params_cond: bool = True
    distribution: str = 'beta'
    resolution: int = 64
    min_scale_trg: float = 0.25
    max_scale: float = 1.0
    anneal_kimg: int = 10000
    alpha: float = 1.0
    beta_val_start: float = 0.001
    beta_val_end: float = 0.8
    mbstd_group_size: int = 4
    discrete_support: Tuple[float, ...] = ()


@dataclass(frozen=True)
class GeneratorConfig:
    """All fields of `tdgp.config.GeneratorConfig`, so that a JAX run's config
    loads strictly. The served path reads the widths, `fp32_only`, the ray and
    marcher settings, `max_batch_res` and `camera`; the depth and camera
    adaptors, the patch settings and the TPU layout knobs are read by the
    training slice or by the JAX package only."""
    z_dim: int = 512
    w_dim: int = 512
    c_dim: int = 0
    map_depth: int = 2
    cbase: int = 32768
    cmax: int = 512
    fmaps: float = 1.0
    img_resolution: int = 256
    img_channels: int = 3
    num_fp16_res: int = 4
    fp32_only: bool = False
    architecture: str = 'skip'
    use_noise: bool = True
    num_ray_steps: int = 32
    max_batch_res: int = 128
    ray_marcher_type: str = 'classical'
    clamp_mode: str = 'softplus'
    density_bias: float = 0.0
    use_full_box: bool = False
    use_inf_depth: bool = True
    has_view_cond: bool = False
    nerf_noise_std_init: float = 1.0
    nerf_noise_kimg_growth: int = 5000
    camera_cond: bool = True
    camera_cond_raw: bool = True
    camera_cond_drop_p: float = 0.0
    camera_cond_spoof_p: float = 0.5
    tri_plane: TriPlaneCfg = TriPlaneCfg()
    depth_adaptor: DepthAdaptorCfg = DepthAdaptorCfg()
    camera_adaptor: CameraAdaptorCfg = CameraAdaptorCfg()
    camera: CameraConfig = CameraConfig()
    patch: PatchCfg = PatchCfg()
    white_back: bool = False
    last_back: bool = False
    plane_sample_impl: str = 'auto'
    plane_pack: str = 'quad_bf16'
    # 'auto' and 'fused' march the final pass in the CUDA kernel
    # (tdgp_torch/ops/ray_march.py); 'jnp' keeps the JAX package's name for
    # the plain marcher, the reference the kernel is held against
    ray_march_impl: str = 'auto'
    sample_save: str = 'auto'
    render_bf16: bool = False
    decoder_remat: bool = True
    merged_splat: bool = True


@dataclass(frozen=True)
class DatasetConfig:
    path: str = ''
    name: str = 'dataset'
    resolution: int = 256
    c_dim: int = 0
    mirror: bool = True
    white_back: bool = False
    last_back: bool = False
    use_embeddings: bool = True
    embedder_name: str = 'resnet50'
    embedding_dim: int = 2048
    embeddings_path: str = ''
    embeddings_desc_path: str = ''
    max_size: Optional[int] = None


@dataclass(frozen=True)
class Config:
    """The sections of an experiment config that serving reads."""
    camera: CameraConfig = CameraConfig()
    generator: GeneratorConfig = GeneratorConfig()
    dataset: DatasetConfig = DatasetConfig()


# Top-level sections of a JAX run's experiment_config.yaml that describe
# training only; the loader passes over them.
_UNSERVED_SECTIONS = ('discriminator', 'loss', 'training', 'model_name',
                      'num_devices', 'run_dir')


def tiny_test_config() -> Config:
    """The generator of `tdgp.config.tiny_test_config`, for tests."""
    cam = CameraConfig()
    tri = TriPlaneCfg(res=32, feat_dim=8, mlp=TriPlaneMLPCfg(n_layers=2, hid_dim=16))
    patch = PatchCfg(resolution=16, min_scale_trg=0.25, mbstd_group_size=2)
    gen = GeneratorConfig(
        z_dim=32, w_dim=32, c_dim=4, cbase=1024, cmax=64, img_resolution=64,
        num_ray_steps=4, tri_plane=tri, patch=patch, camera=cam,
        fp32_only=True,
        depth_adaptor=DepthAdaptorCfg(hid_dim=8, num_hid_layers=2, kernel_size=3),
        camera_adaptor=CameraAdaptorCfg(z_dim=32, c_dim=4, hid_dim=16, embed_dim=8),
    )
    return Config(camera=cam, generator=gen,
                  dataset=DatasetConfig(resolution=64, c_dim=4, embedding_dim=16))


# ------------------------------------------------------------------ loader

def _overlay(value, node):
    """Recursively overlay dict `node` onto dataclass/scalar `value`."""
    if node is None:
        return value
    if dataclasses.is_dataclass(value) and isinstance(node, dict):
        names = {f.name for f in dataclasses.fields(value)}
        updates = {}
        for k, v in node.items():
            if k not in names:
                raise KeyError(f'Unknown config key: {k} (on {type(value).__name__})')
            updates[k] = _overlay(getattr(value, k), v)
        return dataclasses.replace(value, **updates)
    if isinstance(node, list):
        return tuple(node)
    return node


def _served_sections(data: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in data.items() if k not in _UNSERVED_SECTIONS}


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Dotted-key overrides such as `generator.ray_march_impl=fused`."""
    for ov in overrides:
        if '=' not in ov:
            raise ValueError(f'override must be key=value: {ov}')
        key, raw = ov.split('=', 1)
        node: Dict[str, Any] = {}
        cur = node
        parts = key.split('.')
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = yaml.safe_load(raw)
        cfg = _overlay(cfg, _served_sections(node))
    return cfg


def load_config(yaml_path: Optional[str] = None, overrides: Sequence[str] = (),
                finalize: bool = True) -> Config:
    cfg = Config()
    if yaml_path:
        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        cfg = _overlay(cfg, _served_sections(data))
    cfg = apply_overrides(cfg, overrides)
    return finalize_config(cfg) if finalize else cfg


def finalize_config(cfg: Config) -> Config:
    """The derived generator values of `tdgp.infra.experiment.finalize_config`
    that serving reads: output resolution and c_dim from the dataset, the
    top-level camera, and the dataset's background flags."""
    gen = dataclasses.replace(
        cfg.generator, img_resolution=cfg.dataset.resolution,
        c_dim=cfg.dataset.c_dim, camera=cfg.camera,
        white_back=cfg.dataset.white_back, last_back=cfg.dataset.last_back)
    return dataclasses.replace(cfg, generator=gen)
