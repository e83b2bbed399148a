from video_caption_tpu_torch.postprocessing.candidate_ranker import score_sentence, select_best  # noqa: F401
from video_caption_tpu_torch.postprocessing.text_cleaner import clean_text  # noqa: F401
