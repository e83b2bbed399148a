"""The quality loop's align stage in the JAX package and in the port, from
the same init, on the same records, at full width (ViT-B/16, f32, GAP,
remat, ``temporal_mode="diff"``, the 50257-token text tower), on the CPU.

A script, not a test (pytest does not collect it: it takes minutes). It
renders the quality loop's synthetic dataset at the flags given (by default
``chip_smoke.py``'s cut of 4 classes with 2 train videos each, at a reduced
frame size so the CPU can run the full-width model), initialises the JAX
align model from a seed and carries the weights into the port
(``align_params_from_jax_numpy``). Then, at each rate of ``--lrs``, it runs
``--steps`` Adam steps of the symmetric InfoNCE at 0.07 with the batch
every record: the JAX module's step (its loss and ``optax.adam`` under one
``jax.jit``, the batch a ``jax.random.choice`` permutation) and the port's
``tools/quality_loop.align_steps`` on its plain path. One JSON line per
rate: both loss trajectories, the largest relative difference between
them, and the mean off-diagonal cosine of each package's trained video
embeddings (1.0: every record at one point).

Run from the repository root:
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/align_rate_vs_jax.py \\
        [--image_size 32] [--num_frames 2] [--steps 20] [--lrs 1e-3,1e-4] [--out PATH]
"""
import argparse
import json
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from video_caption_tpu.models import align as jal
from video_caption_tpu.models import vit as jvt
from video_caption_tpu_torch.decode.tokenizer import get_tokenizer
from video_caption_tpu_torch.models import align as al
from video_caption_tpu_torch.models import vit as vt
from video_caption_tpu_torch.models.convert import align_params_from_jax_numpy
from video_caption_tpu_torch.tools import quality_loop as ql


def _cos(v: np.ndarray) -> float:
    n = v.shape[0]
    sim = v @ v.T
    return float((sim.sum() - np.trace(sim)) / (n * (n - 1)))


def jax_steps(jcfg, params, videos, ids, mask, steps: int, lr: float):
    n = videos.shape[0]
    optimizer = optax.adam(lr)

    @jax.jit
    def step(p, s, key, videos_a, ids_a, mask_a):
        pick = jax.random.choice(key, n, (n,), replace=False)

        def loss_fn(q):
            v = jal.encode_video(q, videos_a[pick], jcfg)
            t = jal.encode_text(q, ids_a[pick], mask_a[pick], jcfg)
            logits = (v @ t.T) / 0.07
            labels = jnp.arange(n)
            lv = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
            lt = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels)
            return (lv.mean() + lt.mean()) / 2

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = optimizer.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    losses, p, s, key = [], params, optimizer.init(params), jax.random.PRNGKey(7)
    args = jnp.asarray(videos), jnp.asarray(ids.astype(np.int32)), jnp.asarray(mask)
    for _ in range(steps):
        key, sub = jax.random.split(key)
        p, s, loss = step(p, s, sub, *args)
        losses.append(float(loss))
    return p, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image_size", type=int, default=32)
    ap.add_argument("--num_frames", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lrs", default="1e-3,1e-4")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4, help="torch's CPU threads")
    ap.add_argument("--out", help="also write the JSON lines to this path")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    rows = []
    with tempfile.TemporaryDirectory() as root:
        anns = ql.make_synthetic_dataset(root, num_frames=args.num_frames,
                                         image_size=args.image_size, colors=2, shapes=1,
                                         motions=2, sizes=1, train_per_class=2, val_per_class=1)
        records = json.loads(Path(anns["train"]).read_text())
        videos = ql._videos(records, args.num_frames, args.image_size)
        ids, mask = ql._texts(get_tokenizer(), [r["captions"][0] for r in records])
    jcfg = jal.AlignConfig(vit=jvt.ViTConfig(image_size=args.image_size, dtype=jnp.float32,
                                             pool="gap", remat=True), temporal_mode="diff")
    cfg = al.AlignConfig(vit=vt.ViTConfig(image_size=args.image_size, dtype=torch.float32,
                                          pool="gap", remat=True), temporal_mode="diff")
    jp = jal.init_align_params(jax.random.PRNGKey(args.seed), jcfg)
    tp = align_params_from_jax_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for lr in (float(x) for x in args.lrs.split(",")):
        t0 = time.perf_counter()
        jq, jlosses = jax_steps(jcfg, jp, videos, ids, mask, args.steps, lr)
        jax_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tq, losses = ql.align_steps(cfg, tp, torch.from_numpy(videos), torch.from_numpy(ids),
                                    torch.from_numpy(mask), args.steps, lr,
                                    batch_size=videos.shape[0])
        port_s = time.perf_counter() - t0
        with torch.no_grad():
            tv = al.encode_video(tq, torch.from_numpy(videos), cfg).numpy()
        rows.append({
            "image_size": args.image_size, "num_frames": args.num_frames,
            "records": int(videos.shape[0]), "lr": lr, "steps": args.steps,
            "ln_records": float(np.log(videos.shape[0])), "jax": jlosses, "port": losses,
            "max_rel_diff": float(np.max(np.abs(np.subtract(losses, jlosses))
                                         / np.abs(jlosses))),
            "jax_video_cos": _cos(np.asarray(jal.encode_video(jq, videos, jcfg))),
            "port_video_cos": _cos(tv), "jax_s": jax_s, "port_s": port_s})
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
