from video_caption_tpu_torch.preprocessing.frame_loader import list_frames, load_video_array  # noqa: F401
