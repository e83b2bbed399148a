"""Serve the port over HTTP (counterpart of video_caption_tpu/cli/serve.py):

    python -m video_caption_tpu_torch.cli.serve [--host H] [--port P] [--warmup]

Routes: POST /infer and /api/v1/infer ({"frames_dir": ..., and the optional
fields of server/schemas.py}), GET /health. Engines run on the card. With
``--warmup`` the serving-preset engine that requests with default fields
use is built and takes one request (kernel build, graph capture) before
the server listens.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from video_caption_tpu_torch.server.settings import SETTINGS

    p = argparse.ArgumentParser()
    p.add_argument("--host", default=SETTINGS.host)
    p.add_argument("--port", type=int, default=SETTINGS.port)
    p.add_argument("--warmup", action="store_true",
                   help="build and warm the serving engine before accepting requests")
    args = p.parse_args(argv)

    if args.warmup:
        from video_caption_tpu_torch.config import serving_inference_config
        from video_caption_tpu_torch.server.services.model_registry import MODEL_REGISTRY

        # the config the request path builds for default fields
        # (inference_service.request_to_config): the registry keys engines
        # by the whole config, so warming another would leave this one cold
        engine = MODEL_REGISTRY.get_engine(serving_inference_config())
        print(f"warmup finished in {engine.warmup():.1f}s")

    from video_caption_tpu_torch.server.stdlib_server import StdlibServer

    StdlibServer(args.host, args.port).serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
