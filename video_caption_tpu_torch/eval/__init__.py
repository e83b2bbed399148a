"""Quality evaluation (counterpart of video_caption_tpu/eval): BLEU A/B
compare (``eval_compare``), the decode-grid ablation (``ablate_decode``) and
BLEU scoring (``bleu``). Retrieval Recall@K/MRR is not ported."""
