"""Gate, check and timing entry points, run as `python -m graspnet_tpu_torch.scripts.<name>`.

The port is timed by the benchmark (`python3 benchmark/run.py --workload
<cell> ...`) and kernel by kernel by `chip_smoke.py`.  What is here:

- the gates: `overfit_gate` and `learnability_gate` (`--device`), and
  `verify_checkpoint` (a converted reference checkpoint against a golden);
- `multiproc_check`, the multi-process training check (the tests import it);
- timing of what no benchmark cell covers yet, on the card at
  `GraspNetConfig()` by default and at `GraspNetConfig.tiny()` on the CPU
  with `--device cpu --tiny`, for the tests: `bench_service` (the service
  under concurrent requests, max_batch 1 and 8), `bench_test_app` (the
  eval loop), `bench_eval_frame` (the host evaluator) and `bench_scaling`
  (frames/s against device count);
- `span_cost`, the host cost of one span of `utils/tracing.py`."""
