from video_caption_tpu_torch.data.data_loader import MSVDDataset, build_dataloader  # noqa: F401
