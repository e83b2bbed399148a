"""HTTP serving layer of the port (counterpart of video_caption_tpu/server/):
the same routes (POST /infer and /api/v1/infer, GET /health) and request
fields on the standard library's HTTP server; an engine registry that keeps
one engine per distinct config; a coalescing batch queue in front of each
engine."""
