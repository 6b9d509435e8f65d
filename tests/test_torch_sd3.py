"""The port's SD3 path against the JAX package's on the CPU: CLIP pooled
embeddings (CLIP-L and a bigG-shaped tower), the DiT pieces the MMDiT
uses, the MMDiT (with the txt pad and ``kv_len``, with and without q/k
norms, with a learned pos_embed), the rectified-flow ladder and
samplers, T5 (bucket ids, the encoder with and without a mask), the SD3
text encoding and generation at TINY_SD3 and TINY_SD3_T5, the loader,
the JAX init's special leaves and the device rules.

JAX params come from ``random_tree`` (every leaf non-zero, so the
adaLN-Zero gates let every path reach the output) and go through
io/from_jax.py; inputs are made with numpy from a seed; everything is
fp32 on the CPU, where both packages take the bhsd math route for the
joint attention.

Tolerances: modules and 3-step latents rtol/atol 1e-4 (the same
arithmetic through a few dozen layers, summed in another order); images
may differ by 1 where a value sits on a truncation boundary. Exact: the
qkv split (indexing), the flow ladder and the T5 bucket ids. The sin-cos
position table is held to 4e-6 absolute, one fp32 ulp of its largest
argument (63 rad): XLA's exp/sin/cos and torch's differ in the last bit,
and jitted and eager JAX already differ by as much.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu import ops as jops
from tinyfusers_tpu.models import clip as jclip
from tinyfusers_tpu.models import dit as jdit
from tinyfusers_tpu.models import mmdit as jmmdit
from tinyfusers_tpu.models import t5 as jt5
from tinyfusers_tpu.models import vae as jvae
from tinyfusers_tpu.ops import attention as jattn
from tinyfusers_tpu.pipeline import rectified_flow as jrf
from tinyfusers_tpu.pipeline import sd3 as jsd3
from tinyfusers_tpu_torch import ops as tops
from tinyfusers_tpu_torch.io.from_jax import load_params, load_sd3
from tinyfusers_tpu_torch.models import clip as tclip
from tinyfusers_tpu_torch.models import dit as tdit
from tinyfusers_tpu_torch.models import mmdit as tmmdit
from tinyfusers_tpu_torch.models import t5 as tt5
from tinyfusers_tpu_torch.models import vae as tvae
from tinyfusers_tpu_torch.models.layers import init_weights
from tinyfusers_tpu_torch.pipeline import rectified_flow as trf
from tinyfusers_tpu_torch.pipeline import sd3 as tsd3

from torch_parity import few_torch_threads, random_tree  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 3


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def ids(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def t_(x):
    return torch.from_numpy(np.asarray(x))


def as_dict(cfg):
    return dataclasses.asdict(cfg)


# -- configs ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["SD3_MEDIUM_CFG", "SD3_MEDIUM_T5_CFG", "SD35_LARGE_CFG",
                                  "SD35_LARGE_T5_CFG", "TINY_SD3", "TINY_SD3_T5"])
def test_sd3_configs_match_jax(name):
    assert as_dict(getattr(tsd3, name)) == as_dict(getattr(jsd3, name))
    assert getattr(tsd3, name).latent_shape == getattr(jsd3, name).latent_shape


def test_model_configs_match_jax():
    for a, b in [(tmmdit.SD3_MEDIUM, jmmdit.SD3_MEDIUM), (tmmdit.SD35_LARGE, jmmdit.SD35_LARGE),
                 (tmmdit.TINY_MMDIT, jmmdit.TINY_MMDIT),
                 (tmmdit.TINY_MMDIT_QKN, jmmdit.TINY_MMDIT_QKN),
                 (tclip.OPENCLIP_BIGG_CONFIG, jclip.OPENCLIP_BIGG_CONFIG),
                 (tclip.OPENCLIP_H_CONFIG, jclip.OPENCLIP_H_CONFIG),
                 (tt5.T5_XXL, jt5.T5_XXL), (tt5.TINY_T5, jt5.TINY_T5),
                 (tvae.SD3_VAE_CONFIG, jsd3.SD3_MEDIUM_CFG.vae)]:
        assert as_dict(a) == as_dict(b)


# -- ops -------------------------------------------------------------------

def test_packed_beneficial_is_the_joint_attention_route():
    """CPU: false, as the JAX function is off the TPU; CUDA: whole heads
    at >= 1024 query tokens, whatever the TPU's VMEM bounds said."""
    for sq, c, h in [(4224, 1536, 24), (4352, 1536, 24), (1152, 1536, 24), (1032, 64, 4)]:
        assert not tops.packed_beneficial(sq, sq, c, h, 2, device="cpu")
        assert not jattn.packed_beneficial(sq, sq, c, h, 2)
        assert tops.packed_beneficial(sq, sq, c, h, 2, device="cuda")
    assert not tops.packed_beneficial(1000, 1000, 1536, 24, 2, device="cuda")
    assert not tops.packed_beneficial(4224, 4224, 1536, 25, 2, device="cuda")


# -- CLIP pooled -----------------------------------------------------------

L_CFG = dict(vocab_size=128, max_length=8, dim=32, num_layers=3, num_heads=4,
             mlp_dim=64, projection_dim=24)
G_CFG = dict(L_CFG, act="gelu", projection_dim=40)  # bigG-shaped: gelu, projection


@pytest.mark.parametrize("cfg_kw", [L_CFG, G_CFG], ids=["clip_l", "bigg"])
@pytest.mark.parametrize("with_eot", [True, False])
def test_clip_pooled_matches_jax(cfg_kw, with_eot):
    jcfg, tcfg = jclip.CLIPConfig(**cfg_kw), tclip.CLIPConfig(**cfg_kw)
    params = random_tree(lambda k: jclip.init(k, jcfg), 0)
    model = tclip.CLIPTextModel(tcfg, device="cpu")
    load_params(model, params)
    tok = ids(1, 3, 8, 127)  # no EOT id (127) anywhere
    if with_eot:  # EOT at 2, 5 and 7, a second EOT after the first in row 0
        tok[0, 2] = tok[0, 6] = tok[1, 5] = tok[2, 7] = 127
        tok[1, 0] = 126  # a larger non-EOT id would win an argmax(ids)
    want = jax.jit(lambda p, i: jclip.apply_pooled(p, i, jcfg))(params, jnp.asarray(tok))
    with torch.no_grad():
        got = tclip.apply_pooled(model, t_(tok))
        early, pooled = tclip.apply_penultimate_and_pooled(model, t_(tok))
        assert torch.equal(early, tclip.apply(model, t_(tok), skip_final_norm_layers=1))
    assert got.shape == (3, cfg_kw["projection_dim"])
    close(got, want)
    close(pooled, want)


# -- DiT pieces ------------------------------------------------------------

@pytest.mark.parametrize("n,dim", [(4, 64), (8, 64), (32, 1536), (64, 1536)])
def test_pos_embed_2d_matches_jax(n, dim):
    want = np.asarray(jdit._pos_embed_2d(n, dim))
    got = tdit._pos_embed_2d(n, dim).numpy()
    assert got.shape == want.shape == (n * n, dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


def test_split_fused_qkv_is_head_interleaved_bit_for_bit():
    qkv = rand(0, 2, 5, 3 * 4 * 8)
    for a, b in zip(tdit.split_fused_qkv(t_(qkv), 4), jdit.split_fused_qkv(jnp.asarray(qkv), 4)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    q, k, v = tdit.split_fused_qkv(t_(qkv), 4)  # head 1's q is columns 24..31
    np.testing.assert_array_equal(q[:, :, 1].numpy(), qkv[..., 24:32])
    np.testing.assert_array_equal(v[:, :, 0].numpy(), qkv[..., 16:24])


def test_modulate_matches_jax():
    x, sh, sc = rand(0, 2, 5, 8), rand(1, 2, 8), rand(2, 2, 8)
    close(tdit._modulate(t_(x), t_(sh), t_(sc)),
          jdit._modulate(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(sc)), dict(rtol=0, atol=0))


# -- MMDiT -----------------------------------------------------------------

def _mmdit_case(cfg_name, learned_pe=False, side=64, ctx_len=8, b=2):
    jcfg, tcfg = getattr(jmmdit, cfg_name), getattr(tmmdit, cfg_name)
    if learned_pe:  # the learned table is sized by the config's input_size
        jcfg, tcfg = (dataclasses.replace(c, input_size=side) for c in (jcfg, tcfg))
    params = random_tree(lambda k: jmmdit.init(k, jcfg), 3)
    if learned_pe:
        n = side // jcfg.patch_size
        params["pos_embed"] = rand(4, 1, n * n, jcfg.dim) * 0.5
    model = tmmdit.MMDiT(tcfg, learned_pos_embed=learned_pe, device="cpu")
    load_params(model, params)
    x = rand(5, b, side, side, jcfg.in_channels)
    t = np.random.default_rng(6).uniform(0, 1, (b,)).astype(np.float32)
    ctx, pooled = rand(7, b, ctx_len, jcfg.context_dim), rand(8, b, jcfg.pooled_dim)
    want = jax.jit(lambda p, *a: jmmdit.apply(p, *a, jcfg))(
        params, *(jnp.asarray(a) for a in (x, t, ctx, pooled)))
    with torch.no_grad():
        got = tmmdit.apply(model, t_(x), t_(t), t_(ctx), t_(pooled))
    return got, want


@pytest.mark.parametrize("cfg_name,learned_pe", [
    ("TINY_MMDIT", False), ("TINY_MMDIT_QKN", False), ("TINY_MMDIT", True),
])
def test_mmdit_matches_jax_with_the_joint_pad(cfg_name, learned_pe):
    """64x64 latents: 1024 image + 8 text tokens, so the txt stream is
    padded to a joint 1152 and the attention masks keys >= kv_len 1032."""
    got, want = _mmdit_case(cfg_name, learned_pe)
    assert got.shape == (2, 64, 64, 4)
    close(got, want)


def test_mmdit_matches_jax_without_the_pad():
    got, want = _mmdit_case("TINY_MMDIT", side=8)  # 16 + 8 tokens: no pad
    close(got, want)


def test_mmdit_joint_pad_reaches_the_attention_as_kv_len(monkeypatch):
    seen = []
    real = tops.sdpa

    def spy(q, k, v, mask=None, *, scale=None, impl=None, kv_len=None):
        seen.append((tuple(q.shape), kv_len))
        return real(q, k, v, mask, scale=scale, impl=impl, kv_len=kv_len)

    monkeypatch.setattr(tmmdit.ops, "sdpa", spy)
    model = tmmdit.MMDiT(tmmdit.TINY_MMDIT, device="cpu")
    init_weights(model, 0)
    with torch.no_grad():
        tmmdit.apply(model, torch.zeros(1, 64, 64, 4), torch.zeros(1),
                     torch.zeros(1, 77, 32), torch.zeros(1, 16))
    assert seen == [((1, 4, 1152, 16), 1101)] * 2


def test_init_weights_follows_the_jax_init():
    """adaLN-Zero: every mod and the final layer are zeros (the MMDiT is
    the zero map at init, as in the JAX package); gains are ones; T5's
    rel_bias is an embedding."""
    model = tsd3.StableDiffusion3(tsd3.TINY_SD3_T5, device="cpu", seed=0)
    mm = model.mmdit
    for leaf in [mm.final.mod, mm.final.proj] + [s.mod for b in mm.blocks for s in (b.img, b.txt)]:
        assert not leaf.weight.any() and not leaf.bias.any()
    assert mm.blocks[0].img.qkv.weight.std() > 0
    gains = [model.t5.final_norm] + [g for lay in model.t5.layers
                                     for g in (lay.attn_norm, lay.ff_norm)]
    assert all(bool((g.weight == 1).all()) for g in gains)
    assert 0.01 < model.t5.rel_bias.weight.std().item() < 0.04
    qkn = tmmdit.MMDiT(tmmdit.TINY_MMDIT_QKN, device="cpu")
    init_weights(qkn, 0)
    assert bool((qkn.blocks[1].txt.ln_k.weight == 1).all())
    with torch.no_grad():
        out = tmmdit.apply(mm, torch.randn(1, 16, 16, 4), torch.ones(1),
                           torch.randn(1, 8, 64), torch.randn(1, 48))
    assert not out.any()


# -- rectified flow --------------------------------------------------------

@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_flow_ladder_is_bit_for_bit(shift):
    for n in (1, 2, 3, 4, 7, 10, 20, 28, 50):  # 20, 28, 50: 1 - i/n would miss bits
        got = trf.timesteps(n, shift)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jrf.timesteps(n, shift)))


@pytest.mark.parametrize("method", ["euler", "heun"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flow_sample_matches_jax(method, dtype):
    x0 = rand(0, 2, 4, 4, 3)
    a = rand(1, 4, 4, 3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def jfn(x, t):
        return jnp.tanh(x.astype(jnp.float32) * jnp.asarray(a)) + t[:, None, None, None] * 2.0

    def tfn(x, t):
        return torch.tanh(x.float() * t_(a)) + t[:, None, None, None] * 2.0

    want = jrf.sample(jfn, jnp.asarray(x0).astype(jdt), 7, shift=3.0, method=method)
    got = trf.sample(tfn, t_(x0).to(dtype), 7, shift=3.0, method=method)
    assert got.dtype == dtype
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    with pytest.raises(ValueError, match="unknown flow sampler"):
        trf.sample(tfn, t_(x0), 2, method="rk4")


# -- T5 --------------------------------------------------------------------

@pytest.mark.parametrize("cfg_name,qlen", [("T5_XXL", 77), ("T5_XXL", 154), ("TINY_T5", 40)])
def test_t5_buckets_are_bit_for_bit(cfg_name, qlen):
    got = tt5._relative_buckets(qlen, qlen, getattr(tt5, cfg_name))
    want = np.asarray(jt5._relative_buckets(qlen, qlen, getattr(jt5, cfg_name)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_t5_matches_jax(masked):
    cfg = jt5.TINY_T5
    params = random_tree(lambda k: jt5.init(k, cfg), 0)
    model = tt5.T5Encoder(tt5.TINY_T5, device="cpu")
    load_params(model, params)
    tok = ids(1, 2, 20, cfg.vocab_size)
    mask = None
    if masked:
        mask = np.ones((2, 20), np.int32)
        mask[0, 13:] = 0
        mask[1, 5:] = 0
    want = jax.jit(lambda p, i, m: jt5.apply(p, i, cfg, mask=m))(
        params, jnp.asarray(tok), None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = tt5.apply(model, t_(tok), None if mask is None else t_(mask))
    close(got, want)


def test_t5_rms_norm_casts_before_the_weight():
    x, w = rand(0, 3, 16), rand(1, 16) + 1.0
    xb, wb = t_(x).to(torch.bfloat16), t_(w).to(torch.bfloat16)
    got = tt5._rms_norm(xb, wb, 1e-6)
    want = jt5._rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# -- VAE, SD3 config -------------------------------------------------------

def test_vae_decode_with_the_sd3_latent_rules_matches_jax():
    """16 latent channels, scale 1.5305, shift 0.0609, no post_quant_conv,
    at a narrow width."""
    kw = dict(base_channels=16, channel_mult=(1, 1, 2), num_groups=8, latent_channels=16,
              scale_factor=1.5305, shift_factor=0.0609, use_quant_conv=False)
    jcfg, tcfg = jvae.VAEConfig(**kw), tvae.VAEConfig(**kw)
    params = random_tree(lambda k: jvae.init(k, jcfg), 0)
    model = tvae.AutoencoderKL(tcfg, device="cpu")
    load_params(model, params)
    assert not hasattr(model, "post_quant_conv")
    z = rand(1, 1, 4, 4, 16)
    want = jax.jit(lambda *a: jvae.decode(*a, jcfg))(params, jnp.asarray(z))
    with torch.no_grad():
        got = tvae.decode(model, t_(z))
    close(got, want)


# -- the SD3 pipeline ------------------------------------------------------

@pytest.fixture(scope="module", params=["TINY_SD3", "TINY_SD3_T5"])
def tiny(request):
    jcfg, tcfg = getattr(jsd3, request.param), getattr(tsd3, request.param)
    params = random_tree(lambda k: jsd3.init(k, jcfg), 0)
    model = tsd3.StableDiffusion3(tcfg, device="cpu", seed=None)
    load_sd3(model, params)
    rng = np.random.default_rng(1)
    idl, idg = (rng.integers(0, 127, (1, 8)).astype(np.int32) for _ in range(2))
    idl[0, 5] = idg[0, 6] = 127  # EOT
    uids = np.full((1, 8), 127, np.int32)
    uids[0, 0] = 0
    t5ids = ut5 = None
    if jcfg.t5 is not None:
        t5ids = rng.integers(0, 128, (1, 8)).astype(np.int32)
        ut5 = np.zeros((1, 8), np.int32)
    lat = rng.standard_normal((1, *jcfg.latent_shape)).astype(np.float32)
    return jcfg, params, model, (idl, idg, uids, uids, lat), (t5ids, ut5)


def test_sd3_encode_text_matches_jax(tiny):
    jcfg, params, model, (idl, idg, *_), (t5ids, _) = tiny
    want_c, want_p = jax.jit(lambda p, a, b, c: jsd3.encode_text(p, a, b, jcfg, c))(
        params, jnp.asarray(idl), jnp.asarray(idg), None if t5ids is None else jnp.asarray(t5ids))
    with torch.no_grad():
        got_c, got_p = tsd3.encode_text(model, t_(idl), t_(idg),
                                        None if t5ids is None else t_(t5ids))
    assert got_c.shape == (1, 16 if t5ids is not None else 8, 64)
    close(got_c, want_c)
    close(got_p, want_p)


def _jax_latents(jcfg, params, idl, idg, uidl, uidg, lat, t5ids, ut5, method):
    """The latents of jsd3.generate, before the VAE."""
    def run(p, a, b, c, d, x, e, f):
        ctx_c, pool_c = jsd3.encode_text(p, a, b, jcfg, e)
        ctx_u, pool_u = jsd3.encode_text(p, c, d, jcfg, f)
        ctx2 = jnp.concatenate([ctx_u, ctx_c], axis=0)
        pool2 = jnp.concatenate([pool_u, pool_c], axis=0)

        def model_fn(z, t):
            v = jmmdit.apply(p["mmdit"], jnp.concatenate([z, z]), jnp.concatenate([t, t]),
                             ctx2, pool2, jcfg.mmdit)
            return v[:1] + jnp.float32(5.0) * (v[1:] - v[:1])

        return jrf.sample(model_fn, x, STEPS, shift=jcfg.shift, method=method)

    arrs = [None if a is None else jnp.asarray(a) for a in (idl, idg, uidl, uidg, lat, t5ids, ut5)]
    return jax.jit(run)(params, *arrs)


@pytest.mark.parametrize("method", ["euler", "heun"])
def test_sd3_latents_match_jax(tiny, method):
    jcfg, params, model, (idl, idg, uidl, uidg, lat), (t5ids, ut5) = tiny
    want = _jax_latents(jcfg, params, idl, idg, uidl, uidg, lat, t5ids, ut5, method)
    with torch.no_grad():
        c, p = tsd3.encode_text(model, t_(idl), t_(idg), None if t5ids is None else t_(t5ids))
        uc, up = tsd3.encode_text(model, t_(uidl), t_(uidg), None if ut5 is None else t_(ut5))
        got = tsd3.sample_latents(model.mmdit, t_(lat), torch.cat([uc, c]), torch.cat([up, p]),
                                  5.0, num_steps=STEPS, shift=jcfg.shift, method=method)
    close(got, want)


def test_sd3_generate_matches_jax(tiny):
    jcfg, params, model, (idl, idg, uidl, uidg, lat), (t5ids, ut5) = tiny
    extra = {} if t5ids is None else dict(ids_t5=t5ids, uids_t5=ut5)
    want = np.asarray(jsd3.generate(
        params, *(jnp.asarray(a) for a in (idl, idg, uidl, uidg, lat)), jnp.float32(5.0),
        num_steps=STEPS, cfg=jcfg, **{k: jnp.asarray(v) for k, v in extra.items()}))
    got = tsd3.generate(model, *(t_(a) for a in (idl, idg, uidl, uidg, lat)), 5.0,
                        num_steps=STEPS, **{k: t_(v) for k, v in extra.items()}).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, 32, 32, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_load_sd3_writes_every_leaf_and_rejects_bad_trees():
    for name in ("TINY_SD3", "TINY_SD3_T5"):
        params = random_tree(lambda k: jsd3.init(k, getattr(jsd3, name)), 0)
        model = tsd3.StableDiffusion3(getattr(tsd3, name), device="cpu", seed=None)
        load_sd3(model, params)  # raises on a parameter the tree does not write
        blk = params["mmdit"]["blocks"]["txt"]["qkv"]["weight"]  # (depth, in, out)
        np.testing.assert_array_equal(model.mmdit.blocks[1].txt.qkv.weight.numpy(), blk[1].T)
    with pytest.raises(ValueError, match="not in the tree"):
        load_sd3(model, dict(params, t5={k: v for k, v in params["t5"].items()
                                          if k != "rel_bias"}))
    with pytest.raises(ValueError, match="no pos_embed"):
        load_sd3(model, dict(params, mmdit=dict(params["mmdit"],
                                                pos_embed=np.zeros((1, 64, 64), np.float32))))


def test_entry_points_default_to_the_gpu_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tsd3.StableDiffusion3(tsd3.TINY_SD3)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tsd3.initial_latent(0, 1, tsd3.TINY_SD3)
    lat = tsd3.initial_latent(0, 2, tsd3.TINY_SD3, device="cpu")
    assert lat.shape == (2, 16, 16, 4) and lat.dtype == torch.float32


def test_mmdit_block_bf16_against_jax_jit():
    """One bf16 MMDiT block (fp32 layer norms without affine, _modulate,
    the gated residuals, gelu_tanh, joint attention over 64 image and 16
    text tokens) against jax.jit of the JAX block. Every op alone equals
    its jax.jit bit for bit; under one jit XLA on the CPU feeds each layer
    norm the unrounded fp32 residual sum x + g * proj(o), where the port
    (and the JAX ops one by one) round it to bf16 first: the port's layer
    norm of the fp32 sum equals the jit's bit for bit. The block's worst
    difference is held at 2^-4 (two bf16 ulps at its outputs' ~5) and, with
    the share that differs, printed."""
    kw = dict(input_size=8, patch_size=2, in_channels=4, out_channels=4, dim=128, depth=1,
              num_heads=2, context_dim=64, pooled_dim=32, context_len=8)
    cfg_j, cfg_t = jmmdit.MMDiTConfig(**kw), tmmdit.MMDiTConfig(**kw)
    params = random_tree(lambda k: jmmdit._block_init(k, cfg_j, jnp.float32), 5)
    block = tmmdit._Block(cfg_t, device="cpu", dtype=torch.bfloat16)
    load_params(block, params)
    rng = np.random.default_rng(4)
    img, txt, c = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 64, 128), (2, 16, 128), (2, 128)))
    pb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()  # noqa: E731
    want = jax.jit(lambda p, a, b, cc: jmmdit._block(p, a, b, cc, cfg_j))(pb, bf(img), bf(txt), bf(c))
    with torch.no_grad():
        got = tmmdit._block(block, tb(img), tb(txt), tb(c), cfg_t)
    for stream, g, w in zip(("image", "text"), got, want):
        d = np.abs(g.float().numpy() - np.asarray(w, np.float32))
        print(f"bf16 MMDiT block vs jax.jit, {stream} stream: worst |diff| {d.max():.4g} at "
              f"|out| max {np.abs(np.asarray(w, np.float32)).max():.3g}; "
              f"{np.mean(d > 0):.3f} of the outputs differ")
        assert g.dtype == torch.bfloat16 and d.max() <= 2 ** -4
    # where they part: the layer norm after the first gated residual
    x, g1, o = img, c, rng.standard_normal((2, 64, 128)).astype(np.float32)
    w = pb["img"]["proj"]
    res = lambda a, gg, oo: a + gg[:, None, :] * jops.linear(oo, w["weight"], w["bias"])  # noqa: E731
    want_ln = np.asarray(jax.jit(lambda a, gg, oo: jops.layer_norm(res(a, gg, oo)))(
        bf(x), bf(g1), bf(o)), np.float32)
    with torch.no_grad():
        prod = tb(g1)[:, None, :] * block.img.proj(tb(o))
        rounded = tops.layer_norm(tb(x) + prod).float().numpy()
        unrounded = tops.layer_norm(tb(x).float() + prod.float()).bfloat16().float().numpy()
    assert np.mean(rounded != want_ln) > 0.05
    np.testing.assert_array_equal(unrounded, want_ln)
