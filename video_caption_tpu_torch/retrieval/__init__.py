"""Retrieval stack (counterpart of video_caption_tpu/retrieval; reference:
scripts/extract_features.py, build_index*.py, eval_retrieval.py,
query_video.py): frozen-encoder feature extraction on the card,
inner-product index (faiss when available, exact numpy otherwise),
Recall@K/MRR evaluation, and mp4 query."""
