"""Timing and gate entry points, run as `python -m graspnet_tpu_torch.scripts.<name>`:
`bench` (serving frames/s, one JSON line), `bench_crop_kernels` (the fused
kernels alone), `profile_stages` (the inference pipeline stage by stage),
`crop_train_breakdown` (the training crop piece by piece), `bench_train`,
`bench_train_pipeline` and `train_stage_times` (the training step and the
CLI's loop) and `bench_test_app` (the eval loop) run on the card at
`GraspNetConfig()` by default, and at `GraspNetConfig.tiny()` on the CPU
with `--device cpu --tiny`, for the tests; `bench_eval_frame` times the
host evaluator; the gates `overfit_gate` and `learnability_gate` take
`--device`."""
