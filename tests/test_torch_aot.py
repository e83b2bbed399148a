"""The port's request program (engine._fused_infer_program) and its capture
(aot.RequestGraph) on the CPU, at the conftest's tiny geometry in f32.

The program runs uncaptured here (graphs exist only on CUDA; the GPU tests
and chip_smoke.py capture it). Ids compare exactly: the program runs the
same ops on the same inputs as the eager path, and the JAX engine's program
gives the same beam tokens in f32."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from video_caption_tpu.config import CompileConfig
from video_caption_tpu.config import default_inference_config as jax_default_config
from video_caption_tpu.engine import InferenceEngine as JaxEngine
from video_caption_tpu_torch import aot
from video_caption_tpu_torch.config import default_inference_config
from video_caption_tpu_torch.engine import InferenceEngine
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import params_from_jax_numpy
from video_caption_tpu_torch.ops import beam_attention, lm_head

DECODE_CONFIGS = ("default", "use_pallas_decode_attention", "use_pallas_decode_layer",
                  "deferred_decode_cache_write")
WORDS = ("a man woman dog cat is are the on in with red blue small big runs walks plays "
         "sits holds ball car street park table water food girl boy child").split()


class WordTok:
    """Tiny-vocab tokenizer whose decodes are word strings the cleaner keeps."""
    eos_token_id = bos_token_id = pad_token_id = 127
    vocab_size = 128

    def encode(self, text):
        return [b % 127 for b in text.encode()] or [1]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(WORDS[int(i) % len(WORDS)] for i in ids if int(i) != 127)


def port_cfg(jcfg):
    v, g = jcfg.vit, jcfg.gpt2
    return cm.CaptionModelConfig(
        vit=vt.ViTConfig(image_size=v.image_size, patch_size=v.patch_size,
                         embed_dim=v.embed_dim, depth=v.depth, num_heads=v.num_heads,
                         out_dim=v.out_dim, dtype=torch.float32),
        gpt2=g2.GPT2Config(vocab_size=g.vocab_size,
                           max_position_embeddings=g.max_position_embeddings,
                           n_embd=g.n_embd, n_layer=g.n_layer, n_head=g.n_head,
                           dtype=torch.float32),
        prefix_len=jcfg.prefix_len, video_dim=jcfg.video_dim)


@pytest.fixture(scope="module")
def port_params(tiny_cfg, tiny_params):
    return params_from_jax_numpy(jax.tree.map(np.asarray, tiny_params), port_cfg(tiny_cfg), "cpu")


@pytest.fixture(scope="module")
def frames_dirs(tmp_path_factory):
    rng = np.random.RandomState(11)
    dirs = []
    for v, count in enumerate((2, 4, 3)):
        d = tmp_path_factory.mktemp(f"aot{v}")
        for i in range(count):
            Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(d / f"frame_{i:05d}.jpg")
        dirs.append(str(d))
    return dirs


def _video(seed=5):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, 255, (1, 2, 3, 32, 32)).astype(np.uint8))


def _engine(tiny_cfg, port_params, decode="default", seed=0, **overrides):
    compile_kw = {k: overrides.pop(k) for k in list(overrides) if hasattr(CompileConfig, k)}
    if decode != "default":
        compile_kw[decode] = True
    cfg = default_inference_config(ckpt="missing.pt", num_frames=2, image_size=32, **overrides)
    cfg = dataclasses.replace(cfg, compile=dataclasses.replace(cfg.compile, **compile_kw))
    pcfg = port_cfg(tiny_cfg)
    mc = dataclasses.replace(pcfg, gpt2=dataclasses.replace(
        pcfg.gpt2, use_pallas_decode=cfg.compile.use_pallas_decode_attention,
        use_pallas_decode_layer=cfg.compile.use_pallas_decode_layer,
        deferred_cache_write=cfg.compile.deferred_decode_cache_write))
    eng = InferenceEngine(cfg, params=port_params, model_cfg=mc, seed=seed, device="cpu")
    eng.tokenizer = WordTok()
    return eng


@pytest.mark.parametrize("decode", DECODE_CONFIGS)
def test_program_ids_equal_the_eager_groups(tiny_cfg, port_params, decode):
    """(a) The program's ids, group by group, against the eager path's
    (``_generate_group`` on ``compute_prefix``), two engines from one seed
    so the sampled group draws the same noise: exact."""
    fused, eager = (_engine(tiny_cfg, port_params, decode, seed=3) for _ in range(2))
    video = _video()
    program, group_list = fused._fused_infer_program()
    got = program(video)
    prefix = eager.compute_prefix(video)
    pairs = eager._pairs()
    assert [len(idxs) for _, idxs, _, _ in group_list] == [2, 1]
    for (dp, idxs, _, _), ids in zip(group_list, got):
        want = eager._generate_group(prefix.repeat_interleave(len(idxs), dim=0),
                                     [pairs[i][1] for i in idxs], dp)
        assert ids.shape == (len(idxs), dp.max_new_tokens)
        np.testing.assert_array_equal(ids.numpy(), want)


@pytest.mark.parametrize("presets", [("precise", "precise", "natural"),
                                     ("precise", "detailed", "natural")])
def test_program_beam_groups_equal_the_jax_program(tiny_cfg, tiny_params, port_params, presets):
    """(b) The beam groups against the JAX engine's ``_fused_infer_program``
    on the same weights (its pixel program, as tests/test_aot_request_path.py
    pins it): exact."""
    names = dict(zip(("preset1", "preset2", "preset3"), presets))
    jcfg = jax_default_config(ckpt="missing.pt", num_frames=2, image_size=32,
                              compile=dataclasses.replace(CompileConfig(),
                                                          overlap_single_upload=False),
                              **names)
    jax_engine = JaxEngine(jcfg, params=tiny_params, model_cfg=tiny_cfg)
    jax_engine.tokenizer = WordTok()
    port = _engine(tiny_cfg, port_params, **names)
    video = _video(7)
    jprogram, jgroups, _ = jax_engine._fused_infer_program()
    want = jprogram(jax_engine.params, video.numpy(), jax.random.PRNGKey(0))
    program, groups = port._fused_infer_program()
    got = program(video)
    def policies(group_list):
        return [(idxs, dp.num_beams, dp.max_new_tokens, dp.temperature)
                for dp, idxs, _, _ in group_list]

    assert policies(groups) == policies(jgroups)
    beams = [i for i, (dp, *_) in enumerate(groups) if dp.num_beams > 1]
    assert len(beams) == len(set(presets)) - 1
    for i in beams:
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))


def test_program_makes_no_host_synchronisation(tiny_cfg, port_params, monkeypatch):
    """(c) Nothing a capture would refuse hides in the program: every way
    from a tensor to a host value, and every host-to-device upload, raises
    while it runs, in each decode configuration."""
    engines = [_engine(tiny_cfg, port_params, decode) for decode in DECODE_CONFIGS]
    programs = [eng._fused_infer_program()[0] for eng in engines]
    video = _video()

    def refuse(name):
        def raiser(*args, **kwargs):
            raise AssertionError(f"{name} called inside the request program")
        return raiser

    for name in ("item", "cpu", "tolist", "numpy", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
    monkeypatch.setattr(torch, "from_numpy", refuse("torch.from_numpy"))
    monkeypatch.setattr(torch, "tensor", refuse("torch.tensor"))
    for program in programs:
        outs = program(video)
        assert len(outs) == 2


def test_program_and_eager_engines_give_the_same_results(tiny_cfg, port_params, frames_dirs,
                                                        monkeypatch):
    """(d) Two engines from one seed, ``aot_request_program`` on and off,
    over three consecutive requests (the sampled caption included): the same
    ``to_api_dict()``. The engine with it on serves through the program,
    the other through ``generate_presets``. The overlapped cold path is off
    in both, so every request takes the pixel path (its feats program:
    tests/test_torch_overlap.py)."""
    on = _engine(tiny_cfg, port_params, seed=4, overlap_single_upload=False)
    off = _engine(tiny_cfg, port_params, seed=4, aot_request_program=False,
                  overlap_single_upload=False)
    calls = {"program": 0, "eager": 0}
    program, _ = on._fused_infer_program()

    def counted_program(video):
        calls["program"] += 1
        return program(video)

    on._program = (counted_program, on._program[1])
    generate_presets = InferenceEngine.generate_presets

    def counted_presets(self, *args):
        calls["eager"] += 1
        return generate_presets(self, *args)

    monkeypatch.setattr(InferenceEngine, "generate_presets", counted_presets)
    on.warmup()
    off.warmup()
    results = [(on.infer(d).to_api_dict(), off.infer(d).to_api_dict()) for d in frames_dirs]
    assert calls == {"program": 4, "eager": 4}
    for got, want in results:
        assert got == want
    assert results[0][0]["S1"] != "Someone is in the scene."    # not vacuous
    assert len({r[0]["S3"] for r in results}) > 1                # the sampled caption moves


def test_single_request_switches(tiny_cfg, port_params):
    """The program serves one video when both switches of the JAX package
    are on (the default), and never more than one video at once."""
    video = _video()
    assert _engine(tiny_cfg, port_params)._serves_on_program(video)
    assert _engine(tiny_cfg, port_params, fuse_request_program=True,
                   fuse_single_request=False)._serves_on_program(video)
    assert not _engine(tiny_cfg, port_params, aot_request_program=False)._serves_on_program(video)
    assert not _engine(tiny_cfg, port_params, fuse_single_request=False)._serves_on_program(video)
    assert not _engine(tiny_cfg, port_params)._serves_on_program(video.repeat(2, 1, 1, 1, 1))


def test_request_graph_refuses_the_cpu(tiny_cfg, port_params):
    """(e) Graphs exist only on CUDA: a CPU input, a CPU engine's graph and
    build_engine on the CPU raise ValueError."""
    with pytest.raises(ValueError, match="only on CUDA"):
        aot.RequestGraph.capture(lambda x: x + 1, torch.zeros(3))
    with pytest.raises(ValueError, match="only on CUDA"):
        _engine(tiny_cfg, port_params).request_graph(_video())
    with pytest.raises(ValueError, match="only on CUDA"):
        aot.build_engine(device="cpu")


class _StubGraph:
    def __init__(self, outputs, static_input):
        self.outputs, self.static_input, self.replays = outputs, static_input, 0

    def replay(self):
        self.replays += 1
        self.outputs.copy_(self.static_input * 2)


def test_replay_adds_the_captured_launches(monkeypatch):
    """(f) Each replay adds the launches recorded during the capture to the
    wrappers' counters, and returns the static outputs after copying the
    input into the static buffer."""
    monkeypatch.setattr(lm_head, "launches", 7)
    monkeypatch.setattr(beam_attention, "launches", 0)
    static_input, outputs = torch.zeros(4), torch.zeros(4)
    graph = _StubGraph(outputs, static_input)
    rg = aot.RequestGraph(graph, static_input, outputs, {lm_head: 48, beam_attention: 276})
    for i in range(1, 4):
        x = torch.full((4,), float(i))
        out = rg.replay(x)
        assert out is outputs
        torch.testing.assert_close(out, 2 * x, rtol=0, atol=0)
        assert (graph.replays, lm_head.launches, beam_attention.launches) == (i, 7 + 48 * i,
                                                                               276 * i)
    assert aot.launch_counts()[lm_head] == 7 + 48 * 3
