"""The port stands alone: importing every module of `mava_tpu_torch`, and the
scripts that drive it on the GPU (`chip_smoke.py`, `bench_torch.py`), loads
neither `jax` nor any module of `mava_tpu`. Run in a fresh interpreter, since
the test process itself imports both."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, json, pkgutil, sys
import mava_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mava_tpu_torch.__path__, "mava_tpu_torch.")]
for name in names + ["chip_smoke", "bench_torch"]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib")) or m.split(".")[0] == "mava_tpu")
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["leaked"] == []
    # Every slice's modules are walked, the SAC ones included.
    for name in ("mava_tpu_torch.systems.sac.ff_isac", "mava_tpu_torch.envs.mareacher",
                 "mava_tpu_torch.replay.item_buffer", "mava_tpu_torch.ops.gru",
                 "mava_tpu_torch.envs._dynamics", "mava_tpu_torch.envs.pointcloud3d",
                 "mava_tpu_torch.envs.mahumanoid", "mava_tpu_torch.envs.mawalker",
                 "mava_tpu_torch.specs", "mava_tpu_torch.envs.stagger",
                 "mava_tpu_torch.utils.checkpointing", "mava_tpu_torch.utils.tbwriter",
                 "mava_tpu_torch.utils.profiling", "mava_tpu_torch.envs.render",
                 "mava_tpu_torch.examples.render_episode",
                 # the seed axis: the stacked programs and the seed band
                 "mava_tpu_torch.advanced_usage.common",
                 "mava_tpu_torch.advanced_usage.ff_ippo_vmap_seeds",
                 "mava_tpu_torch.advanced_usage.ff_mappo_vmap_seeds",
                 "mava_tpu_torch.advanced_usage.rec_ippo_vmap_seeds",
                 "mava_tpu_torch.advanced_usage.rec_mappo_vmap_seeds",
                 "mava_tpu_torch.advanced_usage.ff_ippo_vmap_sweep",
                 "mava_tpu_torch.advanced_usage.ff_mappo_vmap_sweep",
                 "mava_tpu_torch.advanced_usage.rec_ippo_vmap_sweep",
                 "mava_tpu_torch.advanced_usage.rec_mappo_vmap_sweep",
                 "mava_tpu_torch.advanced_usage.ff_ippo_pbt",
                 "mava_tpu_torch.advanced_usage.rec_ippo_pbt",
                 "mava_tpu_torch.examples.seed_band",
                 # the off-policy seed axis, the vault and recorded experience
                 "mava_tpu_torch.advanced_usage.rec_iql_vmap_seeds",
                 "mava_tpu_torch.advanced_usage.rec_iql_vmap_sweep",
                 "mava_tpu_torch.advanced_usage.ff_isac_vmap_seeds",
                 "mava_tpu_torch.advanced_usage.ff_isac_vmap_sweep",
                 "mava_tpu_torch.advanced_usage.ff_masac_vmap_seeds",
                 "mava_tpu_torch.advanced_usage.ff_masac_vmap_sweep",
                 "mava_tpu_torch.advanced_usage.ff_ippo_store_experience",
                 "mava_tpu_torch.replay.stacked", "mava_tpu_torch.replay.vault",
                 "mava_tpu_torch.examples.bc_from_vault",
                 # data parallelism over ranks
                 "mava_tpu_torch.parallel", "mava_tpu_torch.parallel.mesh",
                 "mava_tpu_torch.parallel.distributed",
                 # the quickstart and the user tools
                 "mava_tpu_torch.examples.quickstart", "mava_tpu_torch.scripts",
                 "mava_tpu_torch.scripts.common", "mava_tpu_torch.scripts.run_seeds",
                 "mava_tpu_torch.scripts.bench_suite", "mava_tpu_torch.scripts.bench_band",
                 "mava_tpu_torch.scripts.bench_envs_sweep",
                 "mava_tpu_torch.scripts.bench_vmap_seeds", "mava_tpu_torch.scripts.bench_mfu"):
        assert name in report["modules"]
