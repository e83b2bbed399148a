"""The PyTorch port's weight bridge (video_caption_tpu_torch/models/convert.py)
against the JAX package's parameters and its reference-format export."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_caption_tpu.config import default_inference_config
from video_caption_tpu.models import caption_model as jcm
from video_caption_tpu.models.convert import save_torch_checkpoint
from video_caption_tpu_torch.engine import InferenceEngine
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import (
    load_reference_state, params_from_jax_numpy, params_to_numpy,
)


def port_cfg(jcfg, dtype=torch.float32):
    v, g = jcfg.vit, jcfg.gpt2
    return cm.CaptionModelConfig(
        vit=vt.ViTConfig(image_size=v.image_size, patch_size=v.patch_size,
                         embed_dim=v.embed_dim, depth=v.depth, num_heads=v.num_heads,
                         out_dim=v.out_dim, dtype=dtype),
        gpt2=g2.GPT2Config(vocab_size=g.vocab_size,
                           max_position_embeddings=g.max_position_embeddings,
                           n_embd=g.n_embd, n_layer=g.n_layer, n_head=g.n_head, dtype=dtype),
        prefix_len=jcfg.prefix_len, video_dim=jcfg.video_dim)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_np(tiny_params):
    return jax.tree.map(np.asarray, tiny_params)


def test_numpy_bridge_round_trip_exact(tiny_cfg, jax_np):
    port = params_from_jax_numpy(jax_np, port_cfg(tiny_cfg), "cpu")
    back = _flat(params_to_numpy(port))
    want = _flat(jax_np)
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].shape == want[k].shape, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_numpy_bridge_casts_floating_leaves(tiny_cfg, jax_np):
    port = params_from_jax_numpy(jax_np, port_cfg(tiny_cfg), "cpu", dtype=torch.bfloat16)
    assert port["decoder"]["blocks"]["attn_w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        port["encoder"]["cls_token"].float().numpy(),
        torch.tensor(jax_np["encoder"]["cls_token"]).bfloat16().float().numpy())


def test_reference_checkpoint_loads_like_numpy_bridge(tiny_cfg, jax_np, tmp_path):
    """save_torch_checkpoint (JAX package) -> .pt -> load_reference_state gives
    exactly the tensors of the numpy bridge."""
    path = tmp_path / "ckpt.pt"
    save_torch_checkpoint(str(path), jax_np, tiny_cfg)
    state = torch.load(path, map_location="cpu", weights_only=True)
    loaded = _flat(params_to_numpy(load_reference_state(state, port_cfg(tiny_cfg))))
    want = _flat(jax_np)
    assert loaded.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(loaded[k], want[k], err_msg=k)


def test_legacy_vit_keys_load(tiny_cfg, jax_np):
    from video_caption_tpu.models.convert import export_torch_state

    state = export_torch_state(jax_np, tiny_cfg)
    legacy = {("vit." + k[len("encoder.backbone."):] if k.startswith("encoder.backbone.") else k): v
              for k, v in state.items()}
    loaded = load_reference_state(legacy, port_cfg(tiny_cfg))
    np.testing.assert_array_equal(loaded["encoder"]["blocks"]["qkv_w"].numpy(),
                                  jax_np["encoder"]["blocks"]["qkv_w"])


def test_engine_loads_reference_checkpoint(tiny_cfg, jax_np, tmp_path):
    path = tmp_path / "model.pt"
    save_torch_checkpoint(str(path), jax_np, tiny_cfg)
    cfg = default_inference_config(ckpt=str(path), num_frames=2, image_size=32)
    eng = InferenceEngine(cfg, model_cfg=port_cfg(tiny_cfg), device="cpu")
    got = _flat(params_to_numpy(eng.params))
    for k, v in _flat(jax_np).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_engine_refuses_unreadable_checkpoint(tiny_cfg, tmp_path):
    (tmp_path / "orbax_dir").mkdir()
    cfg = default_inference_config(ckpt=str(tmp_path / "orbax_dir"), num_frames=2, image_size=32)
    with pytest.raises(RuntimeError, match="will not serve random"):
        InferenceEngine(cfg, model_cfg=port_cfg(tiny_cfg), device="cpu")


def test_random_init_matches_jax_shapes_and_scale(tiny_cfg, jax_np):
    port = _flat(params_to_numpy(cm.init_caption_model(0, port_cfg(tiny_cfg), "cpu")))
    want = _flat(jax_np)
    assert port.keys() == want.keys()
    for k in want:
        assert port[k].shape == want[k].shape, k
    # stddev 0.02 families (truncated normal for the ViT, normal elsewhere)
    for k in ("encoder.blocks.qkv_w", "decoder.wte", "mapper.w"):
        assert abs(port[k].std() - 0.02) < 0.004, (k, port[k].std())
    again = _flat(params_to_numpy(cm.init_caption_model(0, port_cfg(tiny_cfg), "cpu")))
    np.testing.assert_array_equal(again["decoder.wte"], port["decoder.wte"])


def test_full_width_config_geometry():
    """The engine's default model is ViT-B/16 + GPT-2 base, as in the JAX
    package, and stores bf16."""
    from video_caption_tpu_torch.engine import model_config_from_inference

    cfg = model_config_from_inference(default_inference_config())
    assert (cfg.vit.embed_dim, cfg.vit.depth, cfg.vit.num_heads, cfg.vit.seq_len) == (768, 12, 12, 197)
    assert (cfg.gpt2.n_embd, cfg.gpt2.n_layer, cfg.gpt2.vocab_size) == (768, 12, 50257)
    assert cfg.mapper_out == 3072 and cfg.vit.dtype == torch.bfloat16
    f32 = model_config_from_inference(dataclasses.replace(
        default_inference_config(), compile=dataclasses.replace(
            default_inference_config().compile, dtype="float32")))
    assert f32.gpt2.dtype == torch.float32
    assert jnp.dtype(jcm.CaptionModelConfig().vit.dtype) == jnp.bfloat16
