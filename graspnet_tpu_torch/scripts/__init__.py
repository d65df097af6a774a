"""Timing entry points, run as `python -m graspnet_tpu_torch.scripts.<name>`:
`bench` (serving frames/s, one JSON line), `bench_crop_kernels` (the fused
kernels alone), `profile_stages` (the inference pipeline stage by stage) and
`crop_train_breakdown` (the training crop piece by piece).  Each runs on the
card at `GraspNetConfig()` by default; `--device cpu --tiny` runs it at
`GraspNetConfig.tiny()` on the CPU, for the tests."""
