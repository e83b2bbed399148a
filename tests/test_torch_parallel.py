"""The port's multi-device paths (video_caption_tpu_torch/parallel/) against
the JAX package's mesh on the 8 virtual CPU devices of tests/conftest.py.

Each world of ranks (2 or 4 processes over gloo, joined through a file://
store in a fresh temporary directory) is spawned once per module by a
fixture and runs several checks (``dryrun.run_jobs``); it has a timeout
that fails the test rather than hang the suite. The spawned ranks import
the port's ``parallel/dryrun.py`` and never this module. The JAX
references and the port's single-device engines and trainer run here.
The tiny geometry (width 64, 2 layers, 4 heads, vocab 128, f32), with its
biases made non-zero so that a bias added once per rank would show."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_caption_tpu.config import MeshConfig as JMeshConfig
from video_caption_tpu.config import default_inference_config as j_default_config
from video_caption_tpu.config import serving_inference_config as j_serving_config
from video_caption_tpu.engine import InferenceEngine as JaxEngine
from video_caption_tpu.engine import load_params as j_load_params
from video_caption_tpu.parallel import mesh as jmesh
from video_caption_tpu.training import mapper_trainer as jmt
from video_caption_tpu_torch.config import (InferenceConfig, MeshConfig, default_inference_config,
                                            serving_inference_config)
from video_caption_tpu_torch.engine import InferenceEngine, load_params
from video_caption_tpu_torch.models import caption_model as cm
from video_caption_tpu_torch.models import gpt2 as g2
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import params_from_jax_numpy
from video_caption_tpu_torch.parallel import dryrun
from video_caption_tpu_torch.parallel import mesh as pmesh
from video_caption_tpu_torch.training import optim as topt
from video_caption_tpu_torch.training.mapper_trainer import MapperTrainer, TrainArgs

WORLD_TIMEOUT_S = 240
SEED = 5
LR_GPT2 = 1e-3
PARAM_ATOL = 1e-5
"""Parameters after one step, mesh against one device: f32 sums over
the ranks in another order, through Adam's first update (g / |g|)."""
LOSS_TOL = 1e-4          # the mapper step's loss against the JAX trainer's
NORM_RTOL = 1e-5         # the clip's global norm, mesh against one device


def _port_cfg(jcfg):
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


def _with_biases(tree, rng):
    """Every bias leaf (``b`` or ``*_b``) drawn non-zero."""
    return {k: _with_biases(v, rng) if isinstance(v, dict)
            else (0.05 * rng.randn(*v.shape)).astype(np.float32)
            if k == "b" or k.endswith("_b") else v
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def model(tiny_cfg, tiny_params):
    """(JAX params, the port's config, the port's params as numpy), the
    same numbers."""
    jnp_tree = _with_biases(jax.tree.map(np.asarray, tiny_params), np.random.RandomState(3))
    pcfg = _port_cfg(tiny_cfg)
    port = dryrun.to_numpy(params_from_jax_numpy(jnp_tree, pcfg, "cpu"))
    return jax.tree.map(jnp.asarray, jnp_tree), pcfg, port


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return dryrun.make_frame_dirs(tmp_path_factory.mktemp("videos"), 4, seed=7)


def _configs(port: bool):
    """The core presets as three beam-3 ``precise`` (every group
    deterministic) and the serving presets (beam-3, beam-4, sampled)."""
    kw = dict(ckpt="missing.pt", num_frames=2, image_size=32)
    core = (default_inference_config if port else j_default_config)(
        preset1="precise", preset2="precise", preset3="precise", **kw)
    serving = (serving_inference_config if port else j_serving_config)(**kw)
    return {"core": core, "serving": serving}


SWITCHES = {"decode_attention": dict(use_pallas_decode_attention=True,
                                     unified_fused_request=False),
            "deferred": dict(deferred_decode_cache_write=True),
            "split_cache": dict(sample_split_cache=True),
            "int8": dict(quantize_decoder_int8=True)}
"""Decode configurations with the serving presets: the K=1 attention kernel
and the deferred write on local heads, the split cache; int8 block weights
(on a data axis only: with a model axis they raise)."""


def _switched(names):
    serving = _configs(True)["serving"]
    return {n: dataclasses.replace(serving, compile=dataclasses.replace(serving.compile,
                                                                        **SWITCHES[n]))
            for n in names}


TP_SWITCHES = ("decode_attention", "deferred", "split_cache")

BATCHES = [dryrun.mapper_batch(4, seed=s) for s in (11, 12)]


@pytest.fixture(scope="module")
def world4(model, dirs, tmp_path_factory):
    """A 2x2 world's checks."""
    _, pcfg, port = model
    root = tmp_path_factory.mktemp("world4")
    common = dict(shape=(2, 2), model_cfg=pcfg, params=port)
    jobs = [
        ("mesh", "mesh", dict(shape=(2, 2), wrong=(3, 2))),
        ("roundtrip", "roundtrip", dict(shape=(2, 2), params=port)),
        ("row_parallel", "row_parallel", dict(shape=(2, 2))),
        ("engines", "engines", dict(common, configs=_configs(True), dirs=dirs, seed=SEED,
                                    infer=["serving"])),
        ("mapper", "mapper", dict(common, batches=BATCHES, out_dir=str(root / "plain"),
                                  ckpt_dir=str(root / "ckpt"))),
        ("mapper_fsdp", "mapper", dict(common, batches=BATCHES, out_dir=str(root / "fsdp"),
                                       fsdp=True, fsdp_min_elems=0)),
        ("gate", "gate", common),
    ]
    results = dryrun.run_world(4, dryrun.run_jobs, jobs, timeout=WORLD_TIMEOUT_S)
    return results, root


def _chip_payload(root):
    """chip_smoke.py phase 16's payload at the dry run's geometry."""
    mc = dryrun.tiny_model_config()
    return dict(dirs=dryrun.make_frame_dirs(root / "videos", 2), ckpt=str(root / "none.pt"),
                num_frames=2, image_size=32, seed=0, out_dir=str(root),
                batch=dryrun.mapper_batch(4), model_cfg=mc, mapper_cfg=mc)


@pytest.fixture(scope="module")
def chip_payload(tmp_path_factory):
    return _chip_payload(tmp_path_factory.mktemp("chip"))


@pytest.fixture(scope="module")
def world2(model, dirs, chip_payload):
    """A world of 2: the TP (1x2) and the DP (2x1) engines, and chip_smoke.py
    phase 16's rank workers."""
    _, pcfg, port = model
    jobs = [("mesh", "mesh", dict(shape=(1, 2), wrong=(2, 2))),
            ("chip", "chip_ranks", chip_payload)]
    extra = {(1, 2): _switched(TP_SWITCHES), (2, 1): _switched(["int8"])}
    for shape in ((1, 2), (2, 1)):
        tag = f"{shape[0]}x{shape[1]}"
        common = dict(shape=shape, model_cfg=pcfg, params=port, seed=SEED)
        jobs += [(f"engines_{tag}", "engines", dict(common, configs=_configs(True), dirs=dirs,
                                                    infer=["serving"])),
                 (f"switched_{tag}", "engines", dict(common, configs=extra[shape],
                                                     dirs=dirs[:2]))]
    return dryrun.run_world(2, dryrun.run_jobs, jobs, timeout=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def single_engine_results(model, dirs):
    """The port's single-device engines on the same weights and seed."""
    _, pcfg, port = model
    out = {}
    for name, cfg in {**_configs(True), **_switched(SWITCHES)}.items():
        eng = InferenceEngine(cfg, params=dryrun.to_torch(port, "cpu"), model_cfg=pcfg,
                              seed=SEED, device="cpu")
        eng.tokenizer = dryrun.WordTokenizer()
        out[name] = [r.to_api_dict()
                     for r in eng.infer_batch(dirs if name in ("core", "serving") else dirs[:2])]
        if name == "serving":
            out[f"{name}/infer"] = eng.infer(dirs[0]).to_api_dict()
    return out


@pytest.fixture(scope="module")
def jax_mesh_engine_results(tiny_cfg, model, dirs):
    """The JAX engines on its 2x2 mesh (the first 4 virtual devices)."""
    jparams = model[0]
    out = {}
    for name, cfg in _configs(False).items():
        eng = JaxEngine(dataclasses.replace(cfg, mesh=JMeshConfig(data=2, model=2)),
                        params=jparams, model_cfg=tiny_cfg, seed=SEED)
        eng.tokenizer = dryrun.WordTokenizer()
        out[name] = [r.to_api_dict() for r in eng.infer_batch(dirs)]
    return out


@pytest.fixture(scope="module")
def single_trainer(model, tmp_path_factory):
    """The port's single-device trainer after the first batch's step: its
    loss, gradient norm, parameters and best-val checkpoint."""
    _, pcfg, port = model
    root = tmp_path_factory.mktemp("single")
    tr = MapperTrainer(pcfg, dryrun.to_torch(port, "cpu"),
                       TrainArgs(unfreeze_last_gpt2=1, lr_gpt2=LR_GPT2, val_every=10 ** 9,
                                 out_dir=str(root / "out"), ckpt_path=str(root / "ckpt")))
    loss = tr.run_step(BATCHES[0])
    val = tr.evaluate(iter(BATCHES[:1]))
    tr.maybe_checkpoint(val, 0)
    return {"loss": loss, "val": val, "grad_norm": float(tr.grad_norm),
            "params": dryrun.to_numpy(tr.params), "ckpt": root / "ckpt"}


# ---- the sharding rules ----------------------------------------------------

_PRODUCTION = {
    "blocks": {"attn_w": (12, 768, 2304), "proj_w": (12, 768, 768), "ln1_scale": (12, 768),
               "fc_w": (12, 768, 3072), "fc_b": (12, 3072), "out_w": (12, 3072, 768)},
    "wte": (50257, 768),
    "mapper": {"w": (256, 3072), "b": (3072,)},
}


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else np.broadcast_to(np.float32(0), v)
            for k, v in tree.items()}


@pytest.mark.parametrize("replicate", [False, True])
@pytest.mark.parametrize("model_size,fsdp_size,min_elems", [
    (2, 1, None), (2, 4, None), (1, 4, None), (4, 2, None), (2, 2, 0), (1, 8, 0)])
@pytest.mark.parametrize("tree", ["tiny", "production"])
def test_param_specs_match_jax(tiny_params, tree, model_size, fsdp_size, min_elems, replicate):
    """The port's spec tree equals the JAX package's PartitionSpecs (as
    tuples), on the tiny tree and on the production-shaped tree of
    test_fsdp_param_specs, with and without replicate_embeddings and FSDP."""
    params = jax.tree.map(np.asarray, tiny_params) if tree == "tiny" else _shapes(_PRODUCTION)
    kw = {} if min_elems is None else {"fsdp_min_elems": min_elems}
    want = jmesh.param_specs(params, model_size, fsdp_size, replicate_embeddings=replicate, **kw)
    got = pmesh.param_specs(params, model_size, fsdp_size, replicate_embeddings=replicate, **kw)
    assert {p: tuple(s) for p, s in topt.leaves(want)} == dict(topt.leaves(got))


def test_make_mesh_shapes_and_wrong_count(world4, world2):
    """Shapes and coordinates on a 2x2 and a 1x2 world; a mesh whose size
    is not the world's raises ValueError there, and without a process
    group a mesh of more than one device does (one device is the single
    process)."""
    results, _ = world4
    coords = sorted(r["mesh"]["coords"] for r in results)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(r["mesh"]["shape"] == {"data": 2, "model": 2} for r in results)
    assert all("mesh 3x2 != 4 devices" in r["mesh"]["wrong_count_error"] for r in results)
    assert [r["mesh"]["coords"] for r in world2] == [(0, 0), (0, 1)]
    assert all("mesh 2x2 != 2 devices" in r["mesh"]["wrong_count_error"] for r in world2)
    assert pmesh.make_mesh(MeshConfig(1, 1), "cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="process group of 6 ranks"):
        pmesh.make_mesh(MeshConfig(data=3, model=2), "cpu")


def test_shard_batch_rows_and_remainder():
    mesh = pmesh.Mesh(data=2, model=2, data_rank=1, model_rank=0)
    batch = {"x": np.arange(8).reshape(4, 2), "y": torch.arange(4)}
    got = pmesh.shard_batch(batch, mesh)
    np.testing.assert_array_equal(got["x"], [[4, 5], [6, 7]])
    assert got["y"].tolist() == [2, 3]
    with pytest.raises(ValueError, match="do not divide"):
        pmesh.shard_batch({"x": np.zeros((3, 2))}, mesh)


def test_shard_gather_round_trip_is_bit_equal(world4):
    for r in world4[0]:
        assert r["roundtrip"] == {"inference": True, "training": True, "fsdp": True}


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("leaf", ["encoder", "decoder"])
def test_qkv_shard_is_head_grouped(model, model_size, leaf):
    """The local product with a rank's fused QKV shard equals the columns
    of that rank's heads in each of Q, K and V of the full product."""
    _, pcfg, port = model
    full = dryrun.to_torch(port, "cpu")
    w_name, b_name, heads = (("qkv_w", "qkv_b", pcfg.vit.num_heads) if leaf == "encoder"
                             else ("attn_w", "attn_b", pcfg.gpt2.n_head))
    blocks = full[leaf]["blocks"]
    x = torch.randn(5, blocks[w_name].shape[1], generator=torch.Generator().manual_seed(0))
    whole = (x @ blocks[w_name][0] + blocks[b_name][0]).reshape(5, 3, heads, -1)
    for r in range(model_size):
        mesh = pmesh.Mesh(data=1, model=model_size, model_rank=r)
        local, specs = pmesh.shard_params(full, mesh, replicate_embeddings=True)
        lb = local[leaf]["blocks"]
        assert specs[leaf]["blocks"][w_name] == (None, None, "model")
        got = x @ lb[w_name][0] + lb[b_name][0]
        per = heads // model_size
        want = whole[:, :, r * per:(r + 1) * per].reshape(5, -1)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_row_parallel_bias_is_added_once(world4):
    for r in world4[0]:
        got = r["row_parallel"]
        assert got["max_diff"] < 1e-5 < got["bias_max"], got


# ---- the engine under a mesh -----------------------------------------------

def _mesh_results(world4, world2, shape, job="engines"):
    if shape == (2, 2):
        per_rank = [r[job] for r in world4[0]]
    else:
        per_rank = [r[f"{job}_{shape[0]}x{shape[1]}"] for r in world2]
    assert all(r == per_rank[0] for r in per_rank), "the ranks' results differ"
    return per_rank[0]


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1)])
def test_infer_batch_core_matches_jax_mesh_and_single_device(world4, world2, shape,
                                                             single_engine_results,
                                                             jax_mesh_engine_results):
    """``precise`` x 3 (every group deterministic): the whole result equals
    the JAX 2x2 mesh engine's and the port's single-device engine's."""
    got = _mesh_results(world4, world2, shape)["core"]
    assert got == single_engine_results["core"]
    assert got == jax_mesh_engine_results["core"]
    assert any(r["S1"] != "Someone is in the scene." for r in got)    # not vacuous


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1)])
def test_infer_batch_serving_presets(world4, world2, shape, single_engine_results,
                                     jax_mesh_engine_results):
    """The serving presets: every group (the sampled one included: the
    noise of the whole batch from the same generator, each data rank its
    rows) equals the port's single-device engine with the same seed, and
    the beam groups (S1 beam-3, S2 beam-4) equal the JAX 2x2 mesh engine's."""
    got = _mesh_results(world4, world2, shape)["serving"]
    assert got == single_engine_results["serving"]
    want = jax_mesh_engine_results["serving"]
    assert [(r["S1"], r["S2"]) for r in got] == [(r["S1"], r["S2"]) for r in want]


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1)])
def test_infer_runs_its_video_on_every_data_rank(world4, world2, shape, single_engine_results):
    """``infer`` after the serving batch: every rank runs the one video,
    with the single-device engine's result (its generator at the same
    offset, the sampled group included)."""
    got = _mesh_results(world4, world2, shape)["serving/infer"]
    assert got == single_engine_results["serving/infer"]


@pytest.mark.parametrize("name,shape", [(n, (1, 2)) for n in TP_SWITCHES] + [("int8", (2, 1))])
def test_decode_configurations_under_a_mesh(world2, name, shape, single_engine_results):
    """The decode configurations run under TP on a rank's heads (int8 under
    DP) and give the single-device engine's results with the same seed."""
    got = _mesh_results(None, world2, shape, "switched")[name]
    assert got == single_engine_results[name]


@pytest.mark.parametrize("switch", ["quantize_decoder_int8", "use_pallas_decode_layer"])
def test_engine_refuses_int8_and_decode_layer_with_a_model_axis(model, switch):
    """With a model axis above 1 (``config.mesh`` 1x2 with no process
    group: the check comes before the mesh is made) int8 block weights and
    the decode-layer kernel raise NotImplementedError naming the
    configuration."""
    _, pcfg, port = model
    serving = _configs(True)["serving"]
    cfg = dataclasses.replace(serving, mesh=MeshConfig(data=1, model=2),
                              compile=dataclasses.replace(serving.compile, **{switch: True}))
    if switch == "use_pallas_decode_layer":      # a given model config carries the switch
        pcfg = dataclasses.replace(pcfg, gpt2=dataclasses.replace(pcfg.gpt2, **{switch: True}))
    with pytest.raises(NotImplementedError, match=f"{switch} under a mesh with model > 1"):
        InferenceEngine(cfg, params=dryrun.to_torch(port, "cpu"), model_cfg=pcfg, device="cpu")


# ---- the mapper trainer under a mesh ---------------------------------------

@pytest.fixture(scope="module")
def jax_mesh_losses(tiny_cfg, model, tmp_path_factory):
    """The JAX trainer's first-step loss on its 2x2 mesh, plain and FSDP."""
    root = tmp_path_factory.mktemp("jax_mesh")
    mesh = jmesh.make_mesh(JMeshConfig(data=2, model=2), jax.devices()[:4])
    out = {}
    for name, kw in (("mapper", {}), ("mapper_fsdp", dict(fsdp=True, fsdp_min_elems=0))):
        tr = jmt.MapperTrainer(tiny_cfg, model[0],
                               jmt.TrainArgs(unfreeze_last_gpt2=1, lr_gpt2=LR_GPT2,
                                             val_every=10 ** 9, out_dir=str(root / name),
                                             ckpt_path=str(root / f"{name}_ck")),
                               mesh=mesh, **kw)
        out[name] = tr.run_step(dict(BATCHES[0]))
    return out


@pytest.mark.parametrize("name", ["mapper", "mapper_fsdp"])
def test_mapper_step_matches_jax_and_single_device(world4, name, jax_mesh_losses,
                                                   single_trainer):
    """One step under 2x2, plain and FSDP (``fsdp_min_elems=0``): the loss
    within 1e-4 of the JAX trainer's on its 2x2 mesh, the gathered
    parameters within PARAM_ATOL of the single-device port's, a second step
    finite; with FSDP, leaves sharded over data and all-gathers over data
    in the step."""
    per_rank = [r[name] for r in world4[0]]
    got = per_rank[0]
    assert all(r["losses"] == got["losses"] for r in per_rank)
    assert abs(got["losses"][0] - jax_mesh_losses[name]) < LOSS_TOL
    assert abs(got["losses"][0] - single_trainer["loss"]) < LOSS_TOL
    assert abs(got["val"] - single_trainer["val"]) < LOSS_TOL       # evaluate, sharded too
    assert np.isfinite(got["losses"][1])
    assert got["model_sharded"] > 0
    want = dict(topt.leaves(single_trainer["params"]))
    for path, leaf in topt.leaves(got["params"]):
        np.testing.assert_allclose(leaf, want[path], rtol=0, atol=PARAM_ATOL, err_msg=path)
    if name == "mapper_fsdp":
        assert got["data_sharded"] > 0 and got["data_gathers"] > 0
    else:
        assert got["data_sharded"] == 0 and got["data_gathers"] == 0


@pytest.mark.parametrize("name", ["mapper", "mapper_fsdp"])
def test_global_norm_under_sharding_equals_single_device(world4, name, single_trainer):
    for r in world4[0]:
        np.testing.assert_allclose(r[name]["grad_norm"], single_trainer["grad_norm"],
                                   rtol=NORM_RTOL)


def test_global_norm_counts_replicated_pieces_once():
    """global_norm with replicas and a reduce over ranks, emulated on one
    process: two ranks of a model axis, one leaf split over it and one
    replicated."""
    g = torch.arange(1.0, 7.0)
    rep = torch.tensor([3.0, 4.0])
    halves = g.chunk(2)
    per_rank = [topt.global_norm([h, rep], [1, 2]) ** 2 for h in halves]
    total = torch.stack(per_rank).sum().sqrt()
    torch.testing.assert_close(total, topt.global_norm([g, rep]))


def test_decode_collective_gate(world4):
    """With the inference placement, the largest collective of a beam step
    moves at most rows x n_embd elements and none has a vocab-sized dim; a
    [rows, vocab] all-gather of sharded logits trips the gate."""
    for r in world4[0]:
        gate = r["gate"]
        assert gate["ok"] and gate["step_collectives"] > 0, gate
        assert gate["control_tripped"] and gate["control"] == (gate["rows"], 128), gate


def test_gate_trips_on_a_vocab_wide_record():
    from video_caption_tpu_torch.parallel.collectives import Record

    fine = [Record("all_reduce", "model", (6, 64))]
    assert dryrun.decode_collective_gate(fine, 6, 64, 128)[0]
    assert not dryrun.decode_collective_gate(fine + [Record("all_gather", "model", (6, 128))],
                                             6, 64, 128)[0]
    assert not dryrun.decode_collective_gate([Record("all_reduce", "model", (7, 64))],
                                             6, 64, 128)[0]


def test_mesh_checkpoint_loads_into_both_engines(world4, model, tiny_cfg, single_trainer):
    """The best-val checkpoint written under 2x2 (rank 0, the gathered tree)
    loads into the JAX engine's and the port's ``load_params`` with the
    same numbers, within PARAM_ATOL of the single-device trainer's save."""
    _, pcfg, _ = model
    root = world4[1]
    path = root / "ckpt" / "model.pt"
    jloaded = j_load_params(j_default_config(ckpt=str(path)), tiny_cfg, seed=1)
    ported = load_params(InferenceConfig(ckpt=str(path)), pcfg, seed=1, device="cpu")
    single = load_params(InferenceConfig(ckpt=str(single_trainer["ckpt"])), pcfg, seed=1,
                         device="cpu")
    jflat = dict(topt.leaves(jax.tree.map(np.asarray, jloaded)))
    sflat = dict(topt.leaves(single))
    for p, t in topt.leaves(ported):
        np.testing.assert_array_equal(t.numpy(), jflat[p], err_msg=p)
        np.testing.assert_allclose(t.numpy(), sflat[p].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=p)


def test_chip_phase_workers_rehearse_on_the_cpu(world2, chip_payload, tmp_path):
    """chip_smoke.py phase 16's rank workers at the dry run's geometry on the
    CPU (gloo; its one-rank world is NCCL on the card): the ranks agree at
    1x2 and 2x1, the prefix and the prefill logits match a single-device
    engine's, the 2x1 ids equal the single-device engine's on each rank's
    video alone with its rows of the batch's noise; the FSDP step's loss,
    gradient norm and trained leaves the single-device step's; the
    one-rank collectives return their inputs and the engine of that one
    rank takes a 1x1 mesh whose ids equal the single-device engine's."""
    payload = chip_payload
    mc, dirs, batch = payload["model_cfg"], payload["dirs"], payload["batch"]
    ranks = [r["chip"] for r in world2]
    one = dryrun.run_world(1, dryrun.chip_nccl_rank, payload, timeout=WORLD_TIMEOUT_S)[0]
    engine = InferenceEngine(default_inference_config(ckpt=payload["ckpt"], num_frames=2,
                                                      image_size=32),
                             seed=0, model_cfg=mc, device="cpu")
    engine.tokenizer = dryrun.WordTokenizer()
    want = dryrun.engine_request(engine, dirs)
    for shape in ((1, 2), (2, 1)):
        got = [r[shape] for r in ranks]
        for a, b in zip(got[0]["ids"], got[1]["ids"]):
            np.testing.assert_array_equal(a, b)
        for key in ("prefix", "logits"):
            np.testing.assert_allclose(got[0][key], want[key], rtol=1e-4, atol=1e-5)
    assert ranks[0][(2, 1)]["sampled"] == [False, True]     # precise x 2, natural
    for a, b in zip(ranks[0][(2, 1)]["ids"], dryrun.rows_alone_ids(engine, dirs, 2, 0)):
        np.testing.assert_array_equal(a, b)
    single = dryrun.mapper_step(None, mc, batch, 0, str(tmp_path / "single"), torch.device("cpu"))
    fsdp = [r["fsdp"] for r in ranks]
    assert fsdp[0]["loss"] == fsdp[1]["loss"]
    assert abs(fsdp[0]["loss"] - single["loss"]) < LOSS_TOL
    np.testing.assert_allclose(fsdp[0]["grad_norm"], single["grad_norm"], rtol=NORM_RTOL)
    assert fsdp[1]["after"] is None and set(fsdp[0]["after"]) == set(single["before"])
    assert any("/decoder/blocks/" in p for p in single["before"])
    for p, leaf in single["after"].items():
        assert not np.array_equal(leaf, single["before"][p]), p         # trained
        np.testing.assert_allclose(fsdp[0]["after"][p], leaf, rtol=0, atol=PARAM_ATOL, err_msg=p)
    assert fsdp[0]["data_gathers"] > 0 and fsdp[0]["data_sharded"] > 0
    assert one["backend"] == "gloo" and one["on_mesh"] and all(one["same"].values())
    assert one["collectives"] == 6
    for a, b in zip(one["request"]["ids"], want["ids"]):
        np.testing.assert_array_equal(a, b)
    assert [op for op, axis, _ in one["request_collectives"]] == ["all_gather"] * len(want["ids"])
