"""Multi-device work over ``torch.distributed`` (counterpart of
video_caption_tpu/parallel/): a (data, model) mesh of ranks, the JAX
package's sharding rules, and the collectives the model code calls.

The JAX package runs one controller over every device and lets GSPMD insert
the collectives. The port runs one process per rank (``torchrun``, or
``torch.multiprocessing`` with the ``spawn`` start method), holds each
rank's local shards, and calls its collectives explicitly
(``parallel/collectives.py``)."""

from video_caption_tpu_torch.parallel.mesh import (Mesh, gather_params, make_mesh,  # noqa: F401
                                                   shard_batch, shard_params)
