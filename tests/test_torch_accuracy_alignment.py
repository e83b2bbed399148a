"""The port's accuracy gate (video_caption_tpu_torch/bench/accuracy_alignment.py)
on the CPU, against the JAX package's bench/accuracy_alignment.py: the gap
and margin functions of the peaked-logit widening on the same inputs (the
JAX package's own nested functions, rebuilt from their code objects with
the same closure values), and the tiny gate's verdict and tolerances
beside the counterpart keys of the JAX package's report."""
import json
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_aot import port_cfg, port_params  # noqa: F401
from video_caption_tpu.bench import accuracy_alignment as jalign
from video_caption_tpu.models import gpt2 as jg2
from video_caption_tpu_torch.bench import accuracy_alignment as aa
from video_caption_tpu_torch.decode.generate import DecodeParams

REPORT = json.loads((Path(__file__).resolve().parents[1] / "reports"
                     / "accuracy_alignment.json").read_text())


def _jax_nested(name, **free):
    """The function ``name`` defined inside the JAX ``check_alignment``,
    its free variables bound to ``free``."""
    code = next(c for c in jalign.check_alignment.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == name)
    closure = tuple(types.CellType(free[v]) for v in code.co_freevars)
    return types.FunctionType(code, jalign.__dict__, name, None, closure)


def _inputs(port_params, tiny_cfg, seed, b=2, p_len=5):  # noqa: F811
    """Prefix embeddings, the port's greedy path of them (6 tokens; the
    widening's targets) with one random token in it, and a label mask."""
    rng = np.random.RandomState(seed)
    e = (rng.randn(b, p_len, tiny_cfg.gpt2.n_embd) * 0.5).astype(np.float32)
    dp = DecodeParams(max_new_tokens=6, num_beams=4, min_new_tokens=2, eos_id=127)
    tgt, _ = aa.derive_targets(port_params["decoder"], port_cfg(tiny_cfg).gpt2,
                               torch.from_numpy(e), dp)
    tgt = tgt.numpy().astype(np.int32)
    tgt[1, 2] = rng.randint(0, 127)
    lab = np.ones(tgt.shape, np.float32)
    lab[0, 4:] = 0.0
    return e, tgt, lab


def _jax_fns(cfg, b, p_len, t_new):
    seq_len = p_len + t_new
    gaps = _jax_nested("path_gaps", g2=jg2, gpt_off=cfg, p_len=p_len, t_new=t_new,
                       positions=jnp.broadcast_to(jnp.arange(seq_len), (b, seq_len)),
                       ones_mask=jnp.ones((b, seq_len), jnp.int32))
    return gaps, _jax_nested("margin_loss", margin_target=aa.MARGIN_TARGET, path_gaps=gaps)


@pytest.mark.parametrize("seed", [0, 1])
def test_path_gaps_and_margin_loss_equal_the_jax_functions(tiny_cfg, tiny_params,  # noqa: F811
                                                           port_params, seed):
    e, tgt, lab = _inputs(port_params, tiny_cfg, seed)
    jax_gaps, jax_loss = _jax_fns(tiny_cfg.gpt2, *tgt.shape[:1], e.shape[1], tgt.shape[1])
    dec, jdec, cfg = port_params["decoder"], tiny_params["decoder"], port_cfg(tiny_cfg).gpt2
    te, ttgt, tlab = torch.from_numpy(e), torch.from_numpy(tgt).long(), torch.from_numpy(lab)
    got = aa.path_gaps(dec, te, ttgt, cfg).numpy()
    want = np.asarray(jax_gaps(jdec, jnp.asarray(e), jnp.asarray(tgt), jnp.asarray(lab)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got > 0).any() and (got < 0).any()           # both signs: not vacuous
    loss = float(aa.margin_loss(dec, te, ttgt, tlab, cfg))
    want_loss = float(jax_loss(jdec, jnp.asarray(e), jnp.asarray(tgt), jnp.asarray(lab)))
    assert loss == pytest.approx(want_loss, abs=1e-5)


def test_widening_raises_the_margins(tiny_cfg, port_params):  # noqa: F811
    """Adam on the prefix embeddings lowers the hinge loss of a fixed path
    (the tiny model's LayerNorms cap its margins: it only lowers it)."""
    e, tgt, lab = _inputs(port_params, tiny_cfg, 2)
    dec, cfg = port_params["decoder"], port_cfg(tiny_cfg).gpt2
    te, ttgt, tlab = torch.from_numpy(e), torch.from_numpy(tgt).long(), torch.from_numpy(lab)
    before = float(aa.margin_loss(dec, te, ttgt, tlab, cfg))
    wide = aa.widen(dec, te, ttgt, tlab, cfg, steps=20)
    assert float(aa.margin_loss(dec, wide, ttgt, tlab, cfg)) < before - 0.1
    assert torch.equal(te, torch.from_numpy(e))           # the input is not changed


@pytest.fixture(scope="module")
def tiny_gate(tiny_cfg):
    return aa.check_alignment(image_size=32, num_frames=2, device="cpu",
                              model_cfg=port_cfg(tiny_cfg))


def test_tiny_gate_passes_with_the_jax_reports_tolerances(tiny_gate):
    assert tiny_gate["all_ok"] is True
    assert set(tiny_gate) == set(aa.JAX_LEGS) | {"all_ok"}
    assert set(aa.JAX_LEGS.values()) | {"all_ok"} == set(REPORT)
    for leg in (aa.ENCODER_F32, aa.ENCODER_BF16, aa.PREFIX_KERNELS):
        assert tiny_gate[leg]["tol"] == REPORT[aa.JAX_LEGS[leg]]["tol"]
        assert set(tiny_gate[leg]) == set(REPORT[aa.JAX_LEGS[leg]])
    dec, jdec = tiny_gate[aa.DECODE], REPORT[aa.JAX_LEGS[aa.DECODE]]
    for key in ("step_rel_tol", "agreement_floor"):
        assert dec[key] == jdec[key], key
    # the JAX run loosened the peakedness floor to 0.98; the port holds
    # 0.995 on the card, and off it neither gate applies
    assert aa.PEAK_FRAC_FLOOR == 0.995 > jdec["peak_frac_floor"] == 0.98
    assert dec["peak_frac_floor"] == 0.0
    assert set(jdec) - {"beam_attention_backend", "lm_head_backend"} <= set(dec)
    assert dec["token_agreement_rate"] == 1.0 and dec["tokens_equal"] is True
    assert dec["step_logits_rel_err"] == 0.0 and dec["rows"] == 8
    assert 1 <= dec["widening_rounds"] <= aa.WIDEN_ROUNDS


def test_only_one_leg_and_merge(tiny_cfg, tiny_gate, tmp_path, capsys, monkeypatch):
    encoder = aa.check_alignment(image_size=32, num_frames=2, device="cpu", only="encoder",
                                 model_cfg=port_cfg(tiny_cfg))
    assert set(encoder) == {aa.ENCODER_F32, aa.ENCODER_BF16, aa.PREFIX_KERNELS, "all_ok"}
    prior = tmp_path / "prior.json"
    prior.write_text(json.dumps(encoder))
    monkeypatch.setattr(aa, "check_alignment", lambda *a, only=None, **k: {
        aa.DECODE: tiny_gate[aa.DECODE], "all_ok": True})
    assert aa.main(["--only", "decode", "--merge_into", str(prior)]) == 0
    merged = json.loads(capsys.readouterr().out)
    assert set(merged) == set(tiny_gate) and merged["all_ok"] is True


def test_gate_needs_the_card_when_asked_for_it():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aa.check_alignment(device="cuda")
