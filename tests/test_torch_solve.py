"""The articulated envs' batched solve (`ops/solve.py`) on CPU tensors, where it
runs its plain version, against the reference's `jnp.linalg.solve` at every
system size of the envs that integrate through it (MaReacher 2 up to
MaHumanoid 23): general matrices that need row swaps, and the positive
definite mass matrices of the envs' own q̈. The kernel itself is checked
against the plain version on the card (`tests/test_torch_integrator_graph.py`,
`chip_smoke.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu_torch.ops import solve

SIZES = [2, 5, 6, 9, 14, 23]
TOL = dict(rtol=1e-5, atol=1e-5)  # fp32, LAPACK's order on both sides, conditioning ~10


def systems(n: int, batch: int, seed: int):
    """(M, b): M a random matrix whose largest entry of a column is rarely on
    the diagonal, plus n on the diagonal's far corner to keep it well
    conditioned; b uniform."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((batch, n, n)).astype(np.float32)
    m += n * np.eye(n, dtype=np.float32)[::-1]
    return m, rng.uniform(-1, 1, (batch, n)).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
def test_plain_solve_is_the_references(n):
    m, b = systems(n, 16, seed=n)
    got = solve.batched_solve(torch.tensor(m), torch.tensor(b))
    want = np.asarray(jnp.linalg.solve(m, b[..., None])[..., 0])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", m, got.numpy()), b, rtol=1e-4, atol=1e-4)
    assert solve.launches == 0  # the CPU path launches nothing


def test_solve_ex_on_card_is_the_solve_as_a_tuple():
    m, b = systems(6, 4, seed=0)
    (x,) = solve.solve_ex_on_card(torch.tensor(m), torch.tensor(b))
    assert torch.equal(x, solve.batched_solve_reference(torch.tensor(m), torch.tensor(b)))
    with pytest.raises(ValueError):
        solve.solve_ex_on_card(torch.tensor(m), torch.tensor(b), left=False)


@pytest.mark.parametrize("shapes", [((4, 3, 3), (4, 2)), ((3, 3), (3,)), ((4, 3, 2), (4, 3))])
def test_solve_refuses_what_the_kernel_does_not_take(shapes):
    with pytest.raises(ValueError):
        solve.batched_solve(torch.zeros(shapes[0]), torch.zeros(shapes[1]))
