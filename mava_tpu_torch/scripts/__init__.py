"""The port's measuring and seed tools (`python -m mava_tpu_torch.scripts.<name>`),
counterparts of the repo's `scripts/`: `run_seeds`, `bench_suite`, `bench_band`,
`bench_envs_sweep`, `bench_vmap_seeds` and `bench_mfu`. What they share is
`common.py`."""
