"""Training for the PyTorch/CUDA port: the mapper trainer (the checkpoint the
product serves) and the generic loop of the stage-1/2 alignment trainer."""
