"""The pair kernel's Hessian-vector product (K3) in its plain version
(ops/cuda/pairs.pair_hvp_torch) against admp_tpu's Pallas HVP kernel
(``_make_hvp_kernel``, reached by ``jax.vjp`` of ``_pair_bwd_op``) run in
interpret mode at float32, kinds pol/uu/perm at their main-path layouts:
every output (d_gi, d_gj, d_scl, d_scal, d_ct) within 1e-5 relative RMSE.

The direction is P.hvp_directions: random on every output, except the pol
and thole columns of zero-polarizability sites, whose float32 second
derivatives keep no digit in either package (1e2-1e3 relative RMSE against
float64 in both). admp_tpu's second-order interpret compile is slow (up to
two minutes for ``pol``), hence a file of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admp_tpu.ops.pallas.pairs import _pair_bwd_op
from admp_tpu_torch.ops.cuda import pairs as P
from test_torch_realspace import _kernel_tables
from torch_port_cases import rel_err


@pytest.mark.parametrize("kind,lmax", [("pol", 2), ("uu", 1), ("perm", 2)])
def test_pair_hvp_plain_matches_interpret_kernel(kind, lmax):
    x = _kernel_tables(kind, lmax)
    ct = x[4]
    cs = [c.numpy() for c in P.hvp_directions(
        [torch.as_tensor(a) for a in x[:4]], kind, seed=11)]

    def bwd(a, b, c, d, e):
        return _pair_bwd_op(a, b, c, d, e, lmax, 128, True, kind, c.shape[0])

    _, vjp = jax.vjp(bwd, *[jnp.asarray(a) for a in x])
    want = vjp(tuple(jnp.asarray(c) for c in cs))
    got = P.pair_hvp_torch(*[torch.as_tensor(a) for a in (*x[:4], ct, *cs)],
                           lmax, kind)
    for name, a, b in zip(("d_gi", "d_gj", "d_scl", "d_scal", "d_ct"), got,
                          want):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        assert np.all(np.isfinite(a)), name
        assert rel_err(a, b) <= 1e-5, (name, rel_err(a, b))
