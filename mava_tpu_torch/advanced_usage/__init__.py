"""Programs that train S entries as one stacked learner on one card: independent
seeds (`*_vmap_seeds`), a learning-rate sweep (`*_vmap_sweep`) and population
based training (`*_pbt`); port of `mava_tpu/advanced_usage/`. What they share
is `common.py`."""
