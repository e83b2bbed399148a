"""FLOP and byte counts against hand-worked values at the two
configurations, the statistics, and the seeded Poisson schedule with
latency taken from the due time."""
import http.server
import json
import statistics
import threading
import time
import types

import numpy as np
import pytest
import torch

from caption_bench import client, flops, generator, harness, stats, weights
from caption_bench.reference import judge

CORE = json.loads((harness.BENCH_DIR / "configs" / "vitb16_gpt2_core.json").read_text())
SERVING = json.loads((harness.BENCH_DIR / "configs" / "vitb16_gpt2_serving.json").read_text())


def test_encode_flops_by_hand():
    # a frame: 196 patches of 768 values -> 768, then 12 blocks at S = 197
    patch = 2 * 196 * 768 * 768                                   # 231,211,008
    block = (2 * 197 * 768 * 2304 + 2 * 197 * 768 * 768          # QKV, projection
             + 2 * 2 * 197 * 768 * 3072 + 4 * 197 * 197 * 768)   # MLP, attention
    assert block == 2_907_909_120
    frame = patch + 12 * block                                    # 35,126,120,448
    expected = 16 * frame + 2 * 768 * 256 + 2 * 256 * 3072
    assert expected == 562_019_893_248
    assert flops.encode_flops(CORE) == expected


def test_decode_flops_by_hand():
    # the empty prompt is one token: S0 = 4 + 1; 24 tokens = 23 steps
    head = 2 * 768 * 50257
    prefill = 12 * (24 * 768 * 768 * 5 + 2 * 5 * 5 * 768) + head
    per_row = sum(12 * (24 * 768 * 768 + 4 * 768 * (5 + t)) + head for t in range(1, 24))
    assert flops.decode_row_flops(CORE, 1, 24) == (prefill, per_row)
    assert prefill == 927_002_112 and per_row == 5_696_887_296


@pytest.mark.parametrize("cfg,lens", [(CORE, [1, 44, 31]), (SERVING, [1, 44, 31])])
def test_video_flops_sums_the_presets(cfg, lens):
    pols = [judge.policy(p) for p in cfg["presets"]]
    total = flops.encode_flops(cfg)
    for n, p in zip(lens, pols):
        prefill, row = flops.decode_row_flops(cfg, n, p.max_new_tokens)
        total += prefill + p.num_beams * row
    assert flops.video_flops(cfg, lens, pols) == total
    # the encode is most of a video's work; the serving presets add a
    # beam-4 x 40 group in place of a second beam-3 x 24 one
    assert 0.85 < flops.encode_flops(cfg) / total < 0.95


def test_lm_head_cost_by_hand():
    x = torch.zeros(48, 768, dtype=torch.bfloat16)
    wte_t = torch.zeros(768, 50304, dtype=torch.bfloat16)
    out = torch.zeros(48 * 50304 + 2 * 48 * 393 + 2 * 48, dtype=torch.float32)
    f, b = flops.lm_head_cost((x, wte_t, 50257), out)
    assert f == 2 * 48 * 768 * 50257
    assert b == 48 * 768 * 2 + 768 * 50257 * 2 + out.numel() * 4
    pk = flops.PEAKS["NVIDIA H100 80GB HBM3"]
    # bound by bytes: ~0.0234 ms of weight plus ~0.0029 ms of logits
    assert flops.bound_seconds(f, b, pk) == pytest.approx(b / 3.35e12)


def test_beam_attention_cost_by_hand():
    r, b, s0, n, h, t = 6, 2, 10, 24, 768, 5
    q = torch.zeros(r, h, dtype=torch.bfloat16)
    gkv = torch.zeros(n, 2, r, h, dtype=torch.bfloat16)
    pk = torch.zeros(b, s0, h, dtype=torch.bfloat16)
    valid = torch.ones(b, s0, dtype=torch.int32)
    valid[0, :3] = 0                                             # 17 valid columns
    anc = torch.zeros(r, n, dtype=torch.int32)
    out = torch.zeros(r, h, dtype=torch.bfloat16)
    f, nbytes = flops.beam_attention_cost((q, gkv, pk, pk, valid, anc, t, 3, 12, None, None),
                                          {}, out)
    assert f == 4.0 * h * (3 * 17 + r * (t + 1))
    assert nbytes == (r * h * 2 + r * (t + 1) * 2 * h * 2 + 17 * 2 * h * 2
                      + b * s0 * 4 + r * (t + 1) * 4 + r * h * 2)


def test_nearest_rank_percentile_and_rates():
    assert stats.percentile(list(range(1, 101)), 95) == 95
    assert stats.percentile(list(range(1, 21)), 95) == 19
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 50)
    assert stats.rate(480, 20.0) == 24.0
    values = [1.0, 2.0, 2.5, 3.0, 10.0, 2.2]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / med)


def test_weights_one_draw_in_the_served_dtype():
    tiny = json.loads((harness.BENCH_DIR / "tests" / "vitb16_gpt2_core_tiny.json").read_text())
    a = weights.make_params(tiny, 5, "cpu", torch.bfloat16)
    b = weights.make_params(tiny, 5, "cpu", torch.bfloat16)
    c = weights.make_params(tiny, 6, "cpu", torch.bfloat16)
    assert torch.equal(a["decoder"]["wte"], b["decoder"]["wte"])
    assert not torch.equal(a["decoder"]["wte"], c["decoder"]["wte"])
    assert a["encoder"]["blocks"]["qkv_w"].dtype == torch.bfloat16
    assert torch.all(a["decoder"]["blocks"]["ln1_scale"] == 1)
    assert torch.all(a["decoder"]["blocks"]["attn_b"] == 0)
    base = a["encoder"]["patch_embed"]["w"].data_ptr()      # the buffer's first leaf
    assert (a["mapper"]["w"].data_ptr() - base) % 128 == 0


def _fake_bench(seed, seconds):
    return types.SimpleNamespace(rng=np.random.default_rng(harness._seeds(seed, 5)[3]),
                                 seconds=seconds, engine=None,
                                 link_dirs=lambda n: [(f"d{i}", 0) for i in range(n)])


def test_poisson_schedule_is_reproduced_from_the_seed():
    mix = {"loop": "open_poisson", "rate_per_s": 30.0}
    first, again, other = (generator.OpenPoisson(_fake_bench(s, 20.0), mix) for s in
                           (2 ** 31 + 11, 2 ** 31 + 11, 2 ** 31 + 12))
    for loop in (first, again, other):
        loop.schedule(30.0, 20.0)
    assert len(first.due) == len(other.due) == 600
    assert np.array_equal(first.due, again.due)
    assert not np.array_equal(first.due, other.due)
    assert np.all(np.diff(first.due) >= 0) and 0 <= first.due[0] and first.due[-1] < 20.0
    # every seed: the same set of gaps, in its own order
    gaps = [np.sort(np.diff(loop.due, prepend=0.0)) for loop in (first, other)]
    assert np.allclose(gaps[0], gaps[1], rtol=0, atol=1e-9)
    assert first.due[-1] == pytest.approx(other.due[-1], abs=1e-9)


def test_served_rate_counts_the_answers_inside_the_window():
    cell = harness.Cell("served", "c", {}, "t", {"loop": "open_poisson"}, 1, [], [])
    out = generator.Outcome(window_s=10.0, done_s=[1.0, 9.9, 10.0, 10.5],
                            latencies_s=[0.2, 0.3, 0.2, 0.6], videos_done=4)
    values = harness.end_to_end(cell, out, 5.0)
    assert values == {"setup_s": 5.0, "served_per_s": 0.3}


def test_open_loop_latency_counts_from_the_due_time():
    """Four requests due at once to a server that answers one at a time in
    50 ms: the k-th waits for the k - 1 before it, and the time from its
    due time to its answer holds that wait."""
    lock = threading.Lock()

    class Slow(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            with lock:
                time.sleep(0.05)
            body = b'{"BEST": {}}'
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Slow)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        due = time.perf_counter() + 0.05
        out = client.send("127.0.0.1", server.server_address[1], generator.PATH,
                          [b"{}"] * 4, [due] * 4, timeout=30)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert all(r is not None and r[0] for r in out)
    latency = sorted(done - due for _, done, _, _ in out)
    for k, x in enumerate(latency, start=1):
        assert x >= 0.05 * k - 2e-3
    assert latency[-1] < 0.05 * 4 + 1.0


def _gaps_one_position_at_a_time(logits, served, pol, eos):
    """The judge's rule restated position by position, as HF's processors
    run at each step."""
    out = []
    for t in range(judge.evaluated_length(served, eos)):
        s = logits[t].double()
        if pol.num_beams > 1:
            s = torch.log_softmax(s, dim=-1)
        for tok in set(served[:t]):
            s[tok] = s[tok] / pol.repetition_penalty if s[tok] > 0 else s[tok] * pol.repetition_penalty
        n = pol.no_repeat_ngram_size
        for i in range(t - n + 1):
            if served[i:i + n - 1] == served[t - n + 1:t]:
                s[served[i + n - 1]] = float("-inf")
        if t < pol.min_new_tokens:
            s[eos] = float("-inf")
        if pol.do_sample:
            s = s / pol.temperature
            vals = torch.sort(s, descending=True).values[:pol.top_k]
            p = torch.softmax(vals, dim=-1)
            floor = vals[(torch.cumsum(p, dim=-1) - p) < pol.top_p].min()
        else:
            floor = torch.topk(s, 2 * pol.num_beams).values[-1]
        out.append(float("inf") if s[served[t]] == float("-inf")
                   else max(0.0, float(floor - s[served[t]])))
    return out


@pytest.mark.parametrize("preset", [0, 2])
def test_judge_all_positions_at_once_equals_one_at_a_time(preset):
    pol = judge.policy(CORE["presets"][preset])
    gen = torch.Generator().manual_seed(preset)
    vocab, eos = 300, 299
    served = [int(x) for x in torch.randint(0, 40, (24,), generator=gen)]
    served[20] = eos
    served[21:] = [eos] * 3
    n = judge.evaluated_length(served, eos)
    logits = torch.randn(n, vocab, generator=gen)
    logits[:, :40] += 3.0                     # the served tokens near the top
    got = judge.row_gaps(logits, served, pol, eos)
    assert got == pytest.approx(_gaps_one_position_at_a_time(logits, served, pol, eos))
    assert n == 21 and any(g > 0 for g in got)


def _slice(launches, held):
    from caption_bench import profiling

    return profiling.Slice(wall_s=1.0, busy_s=0.6, kernels=100, kernel_s=0.6, by_name={},
                           by_port_kernel=held, device_ops=[], idle_gaps=[], videos=8,
                           launches=launches)


def test_a_trace_that_dropped_kernel_events_is_not_read():
    from caption_bench import readers

    counted = {"lm_head": 48, "beam_attention": 552}
    whole = _slice(counted, {"lm_head_row_stats_kernel": (48, 0.01), "lm_head_mma_kernel":
                             (48, 0.02), "beam_attention_kernel": (552, 0.01)})
    short = _slice(counted, {"lm_head_row_stats_kernel": (47, 0.01),
                             "beam_attention_kernel": (552, 0.01)})
    assert whole.complete and not short.complete
    for s, want in ((whole, True), (short, False)):
        run = types.SimpleNamespace(family="batch", slice=s)
        for read in (readers.idle_share, readers.device_ms_per_video, readers.kernels_per_video):
            assert (read(run, "batch") is not None) is want
    assert readers.idle_share(types.SimpleNamespace(family="batch", slice=whole),
                              "batch") == pytest.approx(40.0)
