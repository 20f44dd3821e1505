"""The bf16 blocks of G and D: port (tdgp_torch) vs JAX package (tdgp).

`tiny_test_config` with `generator.fp32_only=false`: G's blocks 8-32 run in
bfloat16 and block 4 in float32; D's blocks 64-8 run in bfloat16 by its own
default. Both packages start from the same weights (JAX's init, with noise
strengths and biases moved off zero, loaded through `tdgp_torch.weights`).

The floor of a comparison is the relative L2 distance between JAX in bf16
and JAX in float32 on the same inputs. Limits, measured first (witnesses in
CHANGES.md):
  - a block alone, on the same inputs (JAX's block jitted alone), each bf16
    block of G and of D: the share of elements that differ <= MAX_SHARE, the
    relative L2 distance <= BLOCK_OF_FLOOR x the floor. Mutation witness:
    the block forced to float32 exceeds it by far.
  - G's planes and the served image: <= MODEL_OF_FLOOR x the floor; D's
    logits and KD features: <= D_OF_FLOOR x the floor. These are loose, and
    the block test above is what holds the cast points: a float32 sum that
    XLA and oneDNN add in another order flips a bf16 rounding in about 1e-4
    to 1e-3 of a convolution's outputs (the blocks' witness), and through
    the following bf16 blocks each flip moves more roundings, so the two
    packages end up apart by a share of the floor that no cast changes
    (0.18 for the planes, 0.40 for the image, 0.57 / 0.23 for D's logits /
    features here). Mutation witness: the model at float32 throughout (the
    port before the bf16 blocks), at the floor itself.
  - R1's gradient of a gradient through D's bf16 blocks, each conv weight:
    relative L2 to JAX's <= R1_OF_FLOOR x its floor (witness: 0.57-0.92; the
    JAX package on the CPU also sums bias and modulation gradients in bf16).
    Mutation witness: PyTorch's own CPU bf16 convolution, whose double
    backward accumulates in bf16 and loses most of these gradients
    (`ops/upfirdn2d.conv2d` takes the float32 route), up to 10x the floor.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import traverse_util
from jax.experimental.pallas import tpu as pltpu

from tdgp import serving as jax_serving
from tdgp.config import replace as jax_replace
from tdgp.config import tiny_test_config as jax_tiny
from tdgp.models.discriminator import Discriminator as JaxDiscriminator
from tdgp.models.discriminator import DiscriminatorBlock as JaxDBlock
from tdgp.models.epigraf import Generator as JaxGenerator
from tdgp.models.stylegan2 import SynthesisBlock as JaxSBlock
from tdgp.utils.tensor_group import TensorGroup as JaxTensorGroup

from tdgp_torch import serving
from tdgp_torch.config import tiny_test_config
from tdgp_torch.models.discriminator import Discriminator, DiscriminatorBlock
from tdgp_torch.models.epigraf import Generator
from tdgp_torch.models.stylegan2 import SynthesisBlock, fp16_resolution
from tdgp_torch.ops import upfirdn2d as port_fir
from tdgp_torch.weights import _to_port_layout, flat_key, flatten_tree, load_flat

BF = torch.bfloat16
MAX_SHARE = 2e-3      # a block alone: share of its bf16 output's elements that differ
BLOCK_OF_FLOOR = 0.1  # a block alone: relative L2 over the block's floor
MODEL_OF_FLOOR = 0.6  # G's planes, the served image
D_OF_FLOOR = 0.8      # D's logits and KD features
R1_OF_FLOOR = 1.5     # R1's gradient of each conv weight of D's bf16 blocks


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def T(x):
    return torch.from_numpy(np.array(x))


def as_f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def rel_l2(a, b):
    a, b = as_f32(a).astype(np.float64), as_f32(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def of_floor(port, ref, ref_f32):
    return rel_l2(port, ref) / rel_l2(ref, ref_f32)


def moved(variables):
    """Noise strengths at 0.3 and biases off zero, so that both take part."""
    def move(path, a):
        name = str(path[-1])
        if 'noise_strength' in name:
            return jnp.full_like(a, 0.3)
        return a + 0.05 if 'bias' in name else a
    return jax.tree_util.tree_map_with_path(move, variables)


def load(module, variables):
    load_flat(module, flatten_tree(jax.device_get(variables)))
    return module


def force_float32(block):
    """A mutant: the block computes in float32 (its layers cast nothing)."""
    for m in block.modules():
        if getattr(m, 'dtype', None) is not None:
            m.dtype = None
    return block


# ------------------------------------------------------------------ which blocks

def test_block_dtypes_follow_num_fp16_res():
    """fp16_resolution = max(2^(log2(res) + 1 - num_fp16_res), 8): the
    flagship's 512^2 planes run blocks 64-512 in bf16, synth256's D blocks
    256-32, the tiny config's G blocks 8-32 and D blocks 64-8."""
    assert fp16_resolution(512, 4) == 64 and fp16_resolution(256, 4) == 32
    assert fp16_resolution(32, 4) == 8 and fp16_resolution(64, 4) == 8
    cfg = tiny_test_config()
    G = Generator(dataclasses.replace(cfg.generator, fp32_only=False))
    dec = G.synthesis.tri_plane_decoder
    assert {r: getattr(dec, f'b{r}').dtype for r in dec.resolutions} == {
        4: None, 8: BF, 16: BF, 32: BF}
    dec32 = Generator(cfg.generator).synthesis.tri_plane_decoder  # fp32_only
    assert all(getattr(dec32, f'b{r}').dtype is None for r in dec32.resolutions)
    D = Discriminator(cfg.discriminator)
    assert [getattr(D, f'b{r}').dtype for r in D.block_resolutions] == [BF] * 4
    D32 = Discriminator(dataclasses.replace(cfg.discriminator, fp32_only=True))
    assert [getattr(D32, f'b{r}').dtype for r in D32.block_resolutions] == [None] * 4
    assert all(p.dtype == torch.float32 for m in (G, D) for p in m.parameters())


# ------------------------------------------------------------------ blocks alone

@pytest.mark.parametrize('res,cin,cout', [(8, 64, 64), (16, 64, 64), (32, 64, 32)])
@pytest.mark.parametrize('mutant', [False, True], ids=['port', 'mutant-float32'])
def test_synthesis_block_in_bf16(res, cin, cout, mutant):
    """One bf16 block of the decoder (up-conv, conv, ToRGB, the image skip)
    on the same inputs; the mutant computes the block in float32."""
    rng = np.random.RandomState(res)
    x = jnp.asarray(rng.randn(4, res // 2, res // 2, cin).astype(np.float32))
    img = jnp.asarray(rng.randn(4, res // 2, res // 2, 24).astype(np.float32))
    ws = jnp.asarray(rng.randn(4, 3, 32).astype(np.float32))
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        jb = JaxSBlock(cin, cout, 32, res, 24, is_last=False, dtype=dtype)
        if dtype == jnp.float32:
            variables = moved(jb.init({'params': jax.random.PRNGKey(res)}, x, img, ws,
                                      noise_mode='const'))
        out[dtype] = jax.jit(lambda v, *a: jb.apply(v, *a, noise_mode='const'))(
            variables, x, img, ws)
    block = load(SynthesisBlock(cin, cout, 32, res, 24, dtype=BF), variables)
    if mutant:
        force_float32(block)
    with torch.no_grad():
        port = block(T(x), T(img), T(ws))
    assert port[1].dtype == torch.float32 and port[0].dtype == (torch.float32 if mutant else BF)
    for p, ref, ref32 in zip(port, out[jnp.bfloat16], out[jnp.float32]):
        # the share of elements that differ, of the bf16 output x (the image is float32)
        share = float(np.mean(as_f32(port[0]) != as_f32(out[jnp.bfloat16][0])))
        ratio = of_floor(p, ref, ref32)
        if mutant:
            assert share > 10 * MAX_SHARE and ratio > 5 * BLOCK_OF_FLOOR, (share, ratio)
        else:
            assert share <= MAX_SHARE and ratio <= BLOCK_OF_FLOOR, (share, ratio)


# the tiny D's four blocks: (in, tmp, out channels, down, hyper-mod, input size)
D_BLOCKS = {'b64': (0, 16, 32, 1, True, 16), 'b32': (32, 32, 64, 1, True, 16),
            'b16': (64, 64, 64, 2, True, 16), 'b8': (64, 64, 64, 2, True, 8)}


@pytest.mark.parametrize('name', list(D_BLOCKS))
@pytest.mark.parametrize('mutant', [False, True], ids=['port', 'mutant-float32'])
def test_discriminator_block_in_bf16(name, mutant):
    """One bf16 block of D (fromrgb, skip, conv0, conv1 with its
    hyper-modulation and FIR downsampling, the residual sum in bf16) on the
    same inputs; the mutant computes the block in float32."""
    cin, tmp, cout, down, hyper, hw = D_BLOCKS[name]
    rng = np.random.RandomState(hw + cin)
    x = None if cin == 0 else jnp.asarray(rng.randn(4, hw, hw, cin).astype(np.float32),
                                          jnp.bfloat16)
    img = jnp.asarray(rng.uniform(-1, 1, (4, hw, hw, 4)).astype(np.float32))
    c = jnp.asarray(rng.randn(4, 512).astype(np.float32))
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        jb = JaxDBlock(cin, tmp, cout, int(name[1:]), down=down, hyper_mod=hyper, dtype=dtype)
        if dtype == jnp.float32:
            variables = moved(jb.init(jax.random.PRNGKey(hw), x, img, c))
        out[dtype] = jax.jit(lambda v, *a: jb.apply(v, *a))(variables, x, img, c)
    block = load(DiscriminatorBlock(cin, tmp, cout, 4, down=down, hyper_mod=hyper, dtype=BF),
                 variables)
    if mutant:
        force_float32(block)
    with torch.no_grad():
        port = block(None if x is None else T(as_f32(x)).to(BF), T(img), T(c))
    share = float(np.mean(as_f32(port) != as_f32(out[jnp.bfloat16])))
    ratio = of_floor(port, out[jnp.bfloat16], out[jnp.float32])
    if mutant:
        assert share > 10 * MAX_SHARE and ratio > 5 * BLOCK_OF_FLOOR, (share, ratio)
    else:
        assert port.dtype == BF and share <= MAX_SHARE and ratio <= BLOCK_OF_FLOOR, (share, ratio)


# ------------------------------------------------------------------ G: planes and image

def _request(seed, n, z_dim, c_dim):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, z_dim).astype(np.float32),
            np.eye(c_dim, dtype=np.float32)[np.arange(n) % c_dim],
            np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(1.3, 1.8, n),
                      np.zeros(n)], 1).astype(np.float32),
            rng.uniform(15, 30, n).astype(np.float32), np.ones(n, np.float32),
            np.stack([rng.uniform(-3, 3, n), rng.uniform(0, 3, n),
                      rng.uniform(0, 0.1, n)], 1).astype(np.float32)]


@pytest.fixture(scope='module')
def gen():
    """JAX generators at bf16 and float32 with one set of variables; the
    port's at bf16 and, the mutant, at float32, loaded from them."""
    gc = jax_replace(jax_tiny().generator, fp32_only=False, ray_march_impl='fused')
    G = JaxGenerator(gc)
    G32 = JaxGenerator(jax_replace(gc, fp32_only=True))
    req = _request(0, 2, gc.z_dim, gc.c_dim)
    z, c, angles, fov, radius, look_at = map(jnp.asarray, req)
    cam = JaxTensorGroup(angles=angles, fov=fov, radius=radius, look_at=look_at)
    rngs = {k: jax.random.PRNGKey(i + 1)
            for i, k in enumerate(('params', 'noise', 'render', 'depth', 'dropout'))}

    def init_fwd(g):
        g.synthesis.apply_camera_adaptor(cam, z, c)
        return g(z, c, cam, camera_angles_cond=angles, resolution=8)

    g_vars = moved(jax.jit(lambda r: G32.init(r, method=init_fwd))(rngs))
    flat = {'/'.join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(jax.device_get(g_vars)).items()}
    ports = {}
    for name, fp32_only in (('port', False), ('mutant-float32', True)):
        ports[name] = Generator(dataclasses.replace(tiny_test_config().generator,
                                                    fp32_only=fp32_only))
        load_flat(ports[name], flat)
        ports[name].eval()
    return G, G32, g_vars, ports, req


def _planes(G, g_vars, ws):
    return jax.jit(lambda v, w: G.apply(
        v, w, method=lambda g, w_: g.synthesis.decode_planes(w_, noise_mode='const')))(
        g_vars, jnp.asarray(ws))


def check_model(ratio, which, limit):
    if which == 'port':
        assert ratio <= limit, ratio
    else:  # the mutant: no bf16 block at all
        assert ratio > limit, ratio


@pytest.mark.parametrize('which', ['port', 'mutant-float32'])
def test_decoded_planes_in_bf16(gen, which):
    G, G32, g_vars, ports, _ = gen
    port = ports[which]
    ws = np.random.RandomState(1).randn(2, port.synthesis.num_ws, 32).astype(np.float32)
    ref, ref32 = _planes(G, g_vars, ws), _planes(G32, g_vars, ws)
    with torch.no_grad():
        planes = port.synthesis.decode_planes(T(ws))
    assert planes.dtype == torch.float32 and planes.shape == ref.shape
    check_model(of_floor(planes, ref, ref32), which, MODEL_OF_FLOOR)


@pytest.mark.parametrize('which', ['port', 'mutant-float32'])
def test_served_image_in_bf16(gen, which):
    """The whole request, mapping to image, against the JAX serving function
    (K3 through the TPU kernel in interpret mode)."""
    G, G32, g_vars, ports, req = gen
    with pltpu.force_tpu_interpret_mode():
        ref, ref32 = (np.asarray(jax.jit(jax_serving.make_serving_fn(g, g_vars,
                                                                     truncation_psi=0.7))(
            *map(jnp.asarray, req))) for g in (G, G32))
    image = serving.make_serving_fn(ports[which], truncation_psi=0.7)(*req)
    assert image.dtype == torch.float32 and image.shape == ref.shape == (2, 64, 64, 3)
    check_model(of_floor(image, ref, ref32), which, MODEL_OF_FLOOR)


# ------------------------------------------------------------------ D: logits, KD, R1

@pytest.fixture(scope='module')
def disc():
    cfg = jax_tiny().discriminator
    rng = np.random.RandomState(4)
    n = 4
    img = rng.uniform(-1, 1, (n, 16, 16, 4)).astype(np.float32)
    c = np.eye(4, dtype=np.float32)[np.arange(n)]
    pp = {'scales': np.repeat(np.array([[0.5], [0.5], [0.8], [0.8]], np.float32), 2, 1),
          'offsets': rng.uniform(0, 0.2, (n, 2)).astype(np.float32)}
    jpp = {k: jnp.asarray(v) for k, v in pp.items()}
    jd, jd32 = JaxDiscriminator(cfg), JaxDiscriminator(jax_replace(cfg, fp32_only=True))
    variables = moved(jax.jit(lambda k: jd32.init(k, jnp.asarray(img), jnp.asarray(c),
                                                  patch_params=jpp, predict_feat=True))(
        jax.random.PRNGKey(1)))
    port = load(Discriminator(tiny_test_config().discriminator), variables)
    return jd, jd32, variables, port, img, c, pp


def test_discriminator_logits_and_kd_features_in_bf16(disc):
    jd, jd32, variables, port, img, c, pp = disc
    jpp = {k: jnp.asarray(v) for k, v in pp.items()}
    ref, ref32 = (jax.jit(lambda v: d.apply(v, jnp.asarray(img), jnp.asarray(c),
                                            patch_params=jpp, predict_feat=True))(variables)
                  for d in (jd, jd32))
    port32 = load(Discriminator(dataclasses.replace(tiny_test_config().discriminator,
                                                    fp32_only=True)), variables)
    with torch.no_grad():
        got, mutant = (d(T(img), T(c), {k: T(v) for k, v in pp.items()}, predict_feat=True)
                       for d in (port, port32))
    for i, what in enumerate(('logits', 'KD features')):
        assert got[i].dtype == torch.float32
        ratio = of_floor(got[i], ref[i], ref32[i])
        assert ratio <= D_OF_FLOOR, (what, ratio)
        assert of_floor(mutant[i], ref[i], ref32[i]) > D_OF_FLOOR, what


def _r1_weight_grads(disc, conv):
    """R1's gradient of a gradient of the port in bf16 -> {conv weight: grad}."""
    _, _, _, port, img, c, pp = disc
    saved = port_fir.conv2d
    port_fir.conv2d = conv
    import tdgp_torch.ops.conv2d_resample as resample
    resample.conv2d = conv
    try:
        port.zero_grad()
        x = T(img).requires_grad_(True)
        logits, _ = port(x, T(c), {k: T(v) for k, v in pp.items()})
        (g,) = torch.autograd.grad(logits.sum(), x, create_graph=True)
        g.square().sum().backward()
    finally:
        port_fir.conv2d = resample.conv2d = saved
    grads = {n: p.grad.clone() for n, p in port.named_parameters()
             if n.startswith('b') and n.endswith('weight') and 'affine' not in n
             and not n.startswith('b4.')}
    port.zero_grad()
    return grads


@pytest.fixture(scope='module')
def r1_jax(disc):
    jd, jd32, variables, _, img, c, pp = disc
    jpp = {k: jnp.asarray(v) for k, v in pp.items()}

    def penalty(d):
        def fn(params):
            g = jax.grad(lambda x: jnp.sum(d.apply({'params': params}, x, jnp.asarray(c),
                                                   patch_params=jpp)[0]))(jnp.asarray(img))
            return jnp.sum(jnp.square(g))
        return fn
    return [flatten_tree({'params': jax.device_get(jax.jit(jax.grad(penalty(d)))(
        variables['params']))}) for d in (jd, jd32)]


@pytest.mark.parametrize('route', ['port', 'mutant-torch-cpu-bf16-conv'])
def test_r1_gradient_of_a_gradient_through_the_bf16_blocks(disc, r1_jax, route):
    """The conv weights of D's bf16 blocks: R1's penalty differentiated
    twice, with float32 parameters behind the casts."""
    conv = port_fir.conv2d if route == 'port' else F.conv2d
    grads = _r1_weight_grads(disc, conv)
    ref, ref32 = r1_jax
    assert len(grads) == 13
    ratios = {}
    for name, g in grads.items():
        r = _to_port_layout(name, ref[flat_key(name)], g.ndim)
        r32 = _to_port_layout(name, ref32[flat_key(name)], g.ndim)
        ratios[name] = of_floor(g, r, r32)
    if route == 'port':
        assert max(ratios.values()) <= R1_OF_FLOOR, ratios
    else:
        assert max(ratios.values()) > 4 * R1_OF_FLOOR, ratios
