"""Configuration schema and YAML loader for the PyTorch port.

The port keeps its own copy of the dataclasses of `tdgp/config.py`, with
the same field names and defaults, so that an `experiment_config.yaml`
written by a JAX training run loads unchanged.

The loader mirrors `tdgp/infra/experiment.py`: a strict dataclass overlay,
dotted-key overrides, then `finalize_config` for the derived values.
"""
from __future__ import annotations

import dataclasses
import math
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
    loads strictly. The TPU layout knobs (`plane_pack`, `sample_save`,
    `merged_splat`) are read by the JAX package only. Unless `fp32_only`,
    the decoder's `num_fp16_res` highest-resolution blocks run in bfloat16
    (`models/stylegan2.py`); `render_bf16` renders from bf16 planes through
    the bf16 MLP (`models/epigraf.py`)."""
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
class DiscriminatorConfig:
    """Unless `fp32_only`, D's blocks from `num_fp16_res` levels below its
    image resolution up run in bfloat16 (`models/discriminator.py`)."""
    c_dim: int = 0
    cbase: int = 32768
    cmax: int = 512
    fmaps: float = 1.0
    input_resolution: int = 64
    img_channels: int = 4
    num_fp16_res: int = 4
    fp32_only: bool = False
    conv_clamp: float = 256.0
    num_additional_start_blocks: int = 2
    mbstd_group_size: int = 4
    mbstd_num_channels: int = 1
    logits_clamp_val: float = 1e7
    camera_cond: bool = False
    camera_cond_drop_p: float = 0.0
    hyper_mod: bool = True
    patch: PatchCfg = PatchCfg()
    embedding_dim: int = 2048
    map_depth: int = 2


# --------------------------------------------------------------- training

@dataclass(frozen=True)
class KDCfg:
    weight: float = 1.0
    anneal_kimg: int = 100000
    loss_type: str = 'l2'


@dataclass(frozen=True)
class LossConfig:
    adv_loss_type: str = 'non_saturating'
    r1_gamma: float = 0.05
    r1_interval: int = 16
    r1_remat: bool = False
    r1_batch_gpu: Optional[int] = None
    pl_weight: float = 0.0
    pl_start_kimg: int = 0
    pl_batch_shrink: int = 2
    pl_decay: float = 0.01
    blur_init_sigma: float = 10.0
    blur_fade_kimg: int = 200
    style_mixing_prob: float = 0.0
    kd: KDCfg = KDCfg()


@dataclass(frozen=True)
class OptimCfg:
    lr: float = 0.0025
    beta1: float = 0.0
    beta2: float = 0.99
    eps: float = 1e-8
    grad_clip: Optional[float] = None


@dataclass(frozen=True)
class AugmentCfg:
    mode: str = 'noaug'
    p: float = 0.2
    target: float = 0.6
    ada_interval: int = 4
    ada_kimg: int = 500
    xflip: float = 0.0
    rotate90: float = 1.0
    xint: float = 1.0
    scale: float = 1.0
    rotate: float = 1.0
    aniso: float = 1.0
    xfrac: float = 1.0
    brightness: float = 1.0
    contrast: float = 1.0
    lumaflip: float = 1.0
    hue: float = 1.0
    saturation: float = 1.0
    imgfilter: float = 0.0
    noise: float = 0.0
    cutout: float = 0.0


@dataclass(frozen=True)
class TrainingConfig:
    """All fields of `tdgp.config.TrainingConfig`, read by the train step
    (`training/train_step.py`) and the loop (`training/loop.py`)."""
    batch_size: int = 64
    batch_gpu: Optional[int] = None
    test_batch_gpu: int = 4
    dmain_fake_bf16: bool = False
    dmain_reuse_fakes: bool = True
    gmain_render_bf16: bool = False
    use_depth: bool = True
    blur_real_depth_sigma: float = 0.0
    learn_camera_dist: bool = True
    total_kimg: int = 25000
    tick_kimg: int = 4
    val_freq: int = 100
    snap: int = 100
    image_snap: int = 100
    seed: int = 0
    ema_kimg: float = 20.0
    ema_rampup: Optional[float] = 0.05
    ema_start_kimg: float = 0.0
    metrics: Tuple[str, ...] = ('fid2k_full', 'nfs256')
    resume: str = 'latest'
    tensorboard: bool = True
    run_profiling: bool = False
    max_rss_gb: Optional[float] = 100.0
    compact_transfer: bool = True
    g_optim: OptimCfg = OptimCfg(lr=0.0025)
    d_optim: OptimCfg = OptimCfg(lr=0.002)
    augment: AugmentCfg = AugmentCfg()


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
    """A whole experiment config, as `tdgp.config.Config` has it."""
    camera: CameraConfig = CameraConfig()
    generator: GeneratorConfig = GeneratorConfig()
    discriminator: DiscriminatorConfig = DiscriminatorConfig()
    loss: LossConfig = LossConfig()
    training: TrainingConfig = TrainingConfig()
    dataset: DatasetConfig = DatasetConfig()
    model_name: str = '3dgp'
    num_devices: int = 1
    run_dir: str = 'experiments/run'


def is_2d(cfg: Config) -> bool:
    """The 2D StyleGAN2 baseline, not a tri-plane generator."""
    return cfg.model_name == 'stylegan2'


def render_bf16_view(gc: GeneratorConfig, all_blocks: bool = False) -> GeneratorConfig:
    """The config of a bf16 render view of a generator (the JAX step's
    `dataclasses.replace`, `tdgp/training/train_step.py:239-257`):
    `render_bf16` on; with `all_blocks` (`training.dmain_fake_bf16`) also
    every decoder block from 8x8 up in bf16, else (`training.gmain_render_bf16`)
    the blocks at the config's own precision."""
    if all_blocks:
        return dataclasses.replace(gc, render_bf16=True, fp32_only=False, num_fp16_res=16)
    return dataclasses.replace(gc, render_bf16=True)


def imagenet_config() -> Config:
    """`tdgp.config.imagenet_config` (the 'imagenet' preset): the headline
    ImageNet-256 configuration, cbase 65536, cmax 1024, 1000 classes, R1
    gamma 0.05."""
    cam = CameraConfig()
    gen = GeneratorConfig(cbase=65536, cmax=1024, c_dim=1000, camera=cam,
                          camera_adaptor=CameraAdaptorCfg(c_dim=1000))
    disc = DiscriminatorConfig(cbase=65536, cmax=1024, c_dim=1000)
    return Config(camera=cam, generator=gen, discriminator=disc,
                  dataset=DatasetConfig(c_dim=1000, resolution=256),
                  loss=LossConfig(r1_gamma=0.05))


def satellite_config(c_dim: int = 0, resolution: int = 256) -> Config:
    """The satellite-dataset configuration of `tdgp.config.satellite_config`
    (default widths, 64^2 patches), the one `bench.py` times."""
    n_extra = max(0, (resolution // 64).bit_length() - 1)
    gen = GeneratorConfig(c_dim=c_dim, img_resolution=resolution,
                          camera_adaptor=CameraAdaptorCfg(c_dim=c_dim))
    disc = DiscriminatorConfig(c_dim=c_dim, num_additional_start_blocks=n_extra)
    return Config(generator=gen, discriminator=disc,
                  dataset=DatasetConfig(c_dim=c_dim, resolution=resolution))


def stylegan2_config(c_dim: int = 0, resolution: int = 256) -> Config:
    """`tdgp.config.stylegan2_config` (the 'stylegan2' preset): the 2D
    StyleGAN2 baseline at the default widths (cbase 32768, cmax 512, its
    `num_fp16_res` blocks in bf16), D on RGB patches; no depth, no camera
    learning, no KD; path-length regularization (weight 2) and style mixing
    (p 0.9) on."""
    gen = GeneratorConfig(c_dim=c_dim, img_resolution=resolution,
                          depth_adaptor=DepthAdaptorCfg(enabled=False),
                          camera_adaptor=CameraAdaptorCfg(enabled=False, c_dim=c_dim))
    disc = DiscriminatorConfig(c_dim=c_dim, img_channels=3)
    return Config(
        model_name='stylegan2', generator=gen, discriminator=disc,
        loss=LossConfig(pl_weight=2.0, style_mixing_prob=0.9, kd=KDCfg(weight=0.0)),
        training=TrainingConfig(use_depth=False, learn_camera_dist=False),
        dataset=DatasetConfig(c_dim=c_dim, resolution=resolution, use_embeddings=False))


def synth_demo_config() -> Config:
    """`tdgp.config.synth_demo_config` (the 'synth64' preset): the whole 3DGP
    pipeline at 64^2 on the synthetic sphere set
    (`data_scripts/make_synthetic_dataset.py`), tri-planes 3x128^2x16, 32^2
    patches, KD off (the set has no embeddings), ADA with ada_kimg 100; G
    at float32 (`fp32_only`), D's bf16 blocks on."""
    cam = CameraConfig()
    tri = TriPlaneCfg(res=128, feat_dim=16, mlp=TriPlaneMLPCfg(n_layers=2, hid_dim=32))
    patch = PatchCfg(resolution=32, min_scale_trg=0.5, anneal_kimg=100,
                     mbstd_group_size=4)
    gen = GeneratorConfig(
        z_dim=128, w_dim=128, c_dim=4, cbase=8192, cmax=256, img_resolution=64,
        num_ray_steps=16, tri_plane=tri, patch=patch, camera=cam,
        fp32_only=True,
        nerf_noise_kimg_growth=100,
        depth_adaptor=DepthAdaptorCfg(hid_dim=16, num_hid_layers=2,
                                      kernel_size=3, anneal_kimg=100),
        camera_adaptor=CameraAdaptorCfg(z_dim=128, c_dim=4, hid_dim=64,
                                        embed_dim=8))
    disc = DiscriminatorConfig(
        c_dim=4, cbase=8192, cmax=256, input_resolution=32, img_channels=4,
        num_additional_start_blocks=1, mbstd_group_size=4, patch=patch,
        embedding_dim=0)
    return Config(
        camera=cam, generator=gen, discriminator=disc,
        loss=LossConfig(r1_gamma=0.1, kd=KDCfg(weight=0.0), blur_fade_kimg=20),
        training=TrainingConfig(batch_size=32, ema_kimg=10.0, tick_kimg=2,
                                snap=5, image_snap=5, val_freq=5,
                                metrics=('fid2k_full',),
                                augment=AugmentCfg(mode='ada', ada_kimg=100)),
        dataset=DatasetConfig(resolution=64, c_dim=4, use_embeddings=False),
    )


def synth256_config() -> Config:
    """`tdgp.config.synth256_config` (the 'synth256' preset): the satellite
    widths at 256^2 with 64^2 patches on the 256^2 synthetic sphere set,
    KD off, c_dim 4, 100-kimg anneals, batch 16, ADA with ada_kimg 100;
    the bf16 blocks of G (64-512) and D (256-32) on."""
    cfg = satellite_config(c_dim=4, resolution=256)
    patch = dataclasses.replace(cfg.generator.patch, anneal_kimg=100)
    gen = dataclasses.replace(
        cfg.generator, patch=patch, nerf_noise_kimg_growth=100,
        depth_adaptor=dataclasses.replace(cfg.generator.depth_adaptor,
                                          anneal_kimg=100))
    return dataclasses.replace(
        cfg, generator=gen,
        discriminator=dataclasses.replace(cfg.discriminator, embedding_dim=0),
        loss=dataclasses.replace(cfg.loss, kd=KDCfg(weight=0.0)),
        training=TrainingConfig(batch_size=16, tick_kimg=2,
                                snap=5, image_snap=5, val_freq=5,
                                metrics=('fid2k_full',),
                                augment=AugmentCfg(mode='ada', ada_kimg=100)),
        dataset=DatasetConfig(path='data/synth256', name='synth256',
                              resolution=256, c_dim=4, use_embeddings=False),
    )


def tiny_test_config() -> Config:
    """`tdgp.config.tiny_test_config`, for tests."""
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
    disc = DiscriminatorConfig(
        c_dim=4, cbase=1024, cmax=64, input_resolution=16, img_channels=4,
        num_additional_start_blocks=2, mbstd_group_size=2, patch=patch,
        embedding_dim=16)
    return Config(
        camera=cam, generator=gen, discriminator=disc,
        loss=LossConfig(r1_gamma=0.1),
        training=TrainingConfig(batch_size=4, ema_kimg=1.25, metrics=()),
        dataset=DatasetConfig(resolution=64, c_dim=4, embedding_dim=16),
    )


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
        cfg = _overlay(cfg, node)
    return cfg


PRESETS = {
    'default': Config,
    'imagenet': imagenet_config,
    'satellite': satellite_config,
    'stylegan2': stylegan2_config,
    'tiny': tiny_test_config,
    'synth64': synth_demo_config,
    'synth256': synth256_config,
}


def load_config(yaml_path: Optional[str] = None, overrides: Sequence[str] = (),
                preset: str = 'default', finalize: bool = True) -> Config:
    """`preset`, overlaid with the YAML file (whose own 'preset' key, if it
    has one, replaces the base), then with the dotted overrides, then
    finalized. A JAX run's frozen `experiment_config.yaml` loads unchanged."""
    if preset not in PRESETS:
        raise ValueError(f'unknown preset {preset!r}; have {sorted(PRESETS)}')
    cfg = PRESETS[preset]()
    if yaml_path:
        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        base_preset = data.pop('preset', None)
        if base_preset:
            cfg = PRESETS[base_preset]()
        cfg = _overlay(cfg, data)
    cfg = apply_overrides(cfg, overrides)
    return finalize_config(cfg) if finalize else cfg


def finalize_config(cfg: Config) -> Config:
    """The derived values of `tdgp.infra.experiment.finalize_config`: output
    resolution, labels, patch scale and depth channel from the dataset, the
    top-level camera, the discriminator's input, R1's 'auto' gamma and the
    EMA half-life."""
    res = cfg.dataset.resolution
    patch_res = cfg.generator.patch.resolution
    patch = dataclasses.replace(cfg.generator.patch, min_scale_trg=patch_res / res)
    n_extra = int(math.log2(res / patch_res)) if cfg.generator.patch.enabled else 0
    gen = dataclasses.replace(
        cfg.generator, img_resolution=res, c_dim=cfg.dataset.c_dim, patch=patch,
        camera=cfg.camera,
        camera_adaptor=dataclasses.replace(cfg.generator.camera_adaptor,
                                           z_dim=cfg.generator.z_dim,
                                           c_dim=cfg.dataset.c_dim),
        white_back=cfg.dataset.white_back, last_back=cfg.dataset.last_back,
        depth_adaptor=dataclasses.replace(cfg.generator.depth_adaptor,
                                          enabled=cfg.training.use_depth))
    disc = dataclasses.replace(
        cfg.discriminator, c_dim=cfg.dataset.c_dim,
        input_resolution=patch_res if cfg.generator.patch.enabled else res,
        img_channels=4 if cfg.training.use_depth else 3,
        num_additional_start_blocks=n_extra, patch=patch,
        embedding_dim=cfg.dataset.embedding_dim)
    r1_gamma = cfg.loss.r1_gamma
    if r1_gamma < 0:  # the 'auto' sentinel
        r1_gamma = 0.0002 * (res ** 2) / cfg.training.batch_size
    return dataclasses.replace(
        cfg, generator=gen, discriminator=disc,
        loss=dataclasses.replace(cfg.loss, r1_gamma=r1_gamma),
        training=dataclasses.replace(cfg.training,
                                     ema_kimg=cfg.training.batch_size * 0.3125))
