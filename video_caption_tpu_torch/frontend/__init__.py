"""Frontend layer of the port (counterpart of video_caption_tpu/frontend/;
reference: frontend/) — REST client + Chainlit chat app.
Layering rule preserved: NO model/torch/inference imports here; the frontend
talks to the backend over HTTP only (frontend/chainlit_app.py:6-8)."""
