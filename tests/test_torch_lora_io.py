"""The port's Kohya LoRA merge (tinyfusers_tpu_torch/io/lora.py) against
the JAX package's io/lora.py on the CPU, on the synthetic Kohya state of
tests/test_lora.py: module names parse to the same paths at SD1.5 and
TINY, and merging into TINY gives the JAX package's weights bit for bit
(the delta is formed in numpy fp32 on both sides, then one add in the
weight's dtype), in fp32 and bf16, with the same modules skipped.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinyfusers_tpu.io import lora as jlora
from tinyfusers_tpu.pipeline import sd as jsd
from tinyfusers_tpu_torch.io import lora as tlora
from tinyfusers_tpu_torch.io import safetensors_io
from tinyfusers_tpu_torch.pipeline import sd as tsd

from torch_parity import few_torch_threads, tiny_sd  # noqa: F401


def make_lora_entry(name, in_dim, out_dim, r=4, alpha=2.0, seed=0):
    """tests/test_lora.py's synthetic Kohya entry."""
    rng = np.random.default_rng(seed)
    out = {
        f"{name}.lora_down.weight": rng.standard_normal((r, in_dim)).astype(np.float32) * 0.1,
        f"{name}.lora_up.weight": rng.standard_normal((out_dim, r)).astype(np.float32) * 0.1,
    }
    if alpha is not None:
        out[f"{name}.alpha"] = np.float32(alpha)
    return out


def _sd15_module_names():
    names = []
    for blocks, n_attn in (("down_blocks_{}", ((0, 2), (1, 2), (2, 2))),
                           ("up_blocks_{}", ((1, 3), (2, 3), (3, 3)))):
        for b, count in n_attn:
            for a in range(count):
                names.append(f"lora_unet_{blocks.format(b)}_attentions_{a}")
    names.append("lora_unet_mid_block_attentions_0")
    out = []
    for base in names:
        for attn in ("attn1", "attn2"):
            for leaf in ("to_q", "to_k", "to_v", "to_out_0"):
                out.append(f"{base}_transformer_blocks_0_{attn}_{leaf}")
        out += [f"{base}_transformer_blocks_0_ff_net_0_proj",
                f"{base}_transformer_blocks_0_ff_net_2"]
    for layer in (0, 5, 11):
        out += [f"lora_te_text_model_encoder_layers_{layer}_self_attn_{p}"
                for p in ("q_proj", "k_proj", "v_proj", "out_proj")]
        out += [f"lora_te_text_model_encoder_layers_{layer}_mlp_{p}" for p in ("fc1", "fc2")]
    return out


@pytest.mark.parametrize("preset", ["sd15", "tiny"])
def test_parse_kohya_module_matches_jax(preset):
    jcfg, tcfg = (jsd.SD15, tsd.SD15) if preset == "sd15" else (jsd.TINY, tsd.TINY)
    names = _sd15_module_names()
    parsed = 0
    for name in names:
        try:
            want = jlora.parse_kohya_module(name, jcfg.unet)
        except KeyError:
            with pytest.raises(KeyError):
                tlora.parse_kohya_module(name, tcfg.unet)
            continue
        assert tlora.parse_kohya_module(name, tcfg.unet) == want, name
        parsed += 1
    assert parsed > 0
    if preset == "sd15":
        assert parsed == len(names)
    for bad in ("lora_unet_conv_in", "lora_unet_down_blocks_0_resnets_0_conv1"):
        with pytest.raises(KeyError):
            tlora.parse_kohya_module(bad, tcfg.unet)


def test_group_lora_state_matches_jax():
    state = {**make_lora_entry("lora_unet_a", 4, 4), **make_lora_entry("lora_te_b", 4, 4),
             "lora_unet_c.lora_up.weight": np.zeros((4, 2), np.float32)}
    want = jlora.group_lora_state(state)
    got = tlora.group_lora_state(state)
    assert {k: set(v) for k, v in got.items()} == {k: set(v) for k, v in want.items()}


def _state(cfg):
    """Entries for a UNet self- and cross-attention, an FF projection, a text
    encoder MLP and attention leaf (one without alpha), an unknown module
    and one with only its up half."""
    d, ctx, te = cfg.unet.model_channels, cfg.unet.context_dim, cfg.clip.dim
    blk = "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0"
    up = "lora_unet_up_blocks_1_attentions_2_transformer_blocks_0"
    state = {}
    for i, (name, i_dim, o_dim, alpha) in enumerate([
            (f"{blk}_attn1_to_q", d, d, 4.0), (f"{blk}_attn2_to_k", ctx, d, 2.0),
            (f"{up}_ff_net_0_proj", d, 8 * d, 1.0), (f"{up}_attn1_to_out_0", d, d, 3.0),
            ("lora_te_text_model_encoder_layers_1_mlp_fc1", te, cfg.clip.mlp_dim, 2.0),
            ("lora_te_text_model_encoder_layers_0_self_attn_v_proj", te, te, None),
            ("lora_unet_some_unknown_thing", 8, 8, 1.0)]):
        state.update(make_lora_entry(name, i_dim, o_dim, r=2, alpha=alpha, seed=i))
    state["lora_unet_half_only.lora_up.weight"] = np.zeros((4, 2), np.float32)
    return state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_matches_jax_bit_for_bit(dtype, tmp_path):
    params, model, _, _, _ = tiny_sd(jsd, tsd, jsd.TINY, tsd.TINY, seed=0)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    jparams = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), params)
    model = model.to(tdt)
    state = _state(jsd.TINY)
    want, jskipped = jlora.merge_lora(jparams, state, scale=0.5, cfg=jsd.TINY)
    safetensors_io.save_state_dict(state, tmp_path / "lora.safetensors")
    before = {n: p.clone() for n, p in model.named_parameters()}
    skipped = tlora.merge_lora(model, tlora.load_lora(tmp_path / "lora.safetensors"),
                               scale=0.5, cfg=tsd.TINY)
    assert sorted(skipped) == sorted(jskipped) == ["lora_unet_half_only",
                                                  "lora_unet_some_unknown_thing"]
    # the merged model holds the JAX tree's weights: load the tree into a
    # fresh model and compare every parameter
    from tinyfusers_tpu_torch.io.from_jax import load_sd

    ref = tsd.StableDiffusion(tsd.TINY, device="cpu", seed=None)
    load_sd(ref, jax.tree.map(lambda x: np.asarray(x, np.float32), want))
    ref = ref.to(tdt)
    changed = 0
    for (n, p), (_, r) in zip(model.named_parameters(), ref.named_parameters()):
        assert torch.equal(p, r), n
        changed += not torch.equal(p, before[n])
    assert changed == 6
