"""Benchmark dataloaders: VideoMME, WorldSense, VideoMMMU (counterparts of
``open_o3_video_tpu/eval/dataloaders/``)."""
