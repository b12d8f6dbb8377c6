"""State carried across from the JAX package (pprx_torch.convert): run the
JAX fast driver 3 slides, write its checkpoint, load it into the port, and
step both 3 more slides in f64 (one snapshot rebuild on the way)."""

import jax.numpy as jnp
import numpy as np
import torch

from pprx.config import PprConfig, StreamConfig
from pprx.graph.fast_stream import FastStreamDriver as JaxDriver
from pprx.graph.io import synthetic_powerlaw_stream
from pprx.io.checkpoint import save_checkpoint
from pprx_torch.convert import state_from_arrays
from pprx_torch.engine.state import FORWARD
from pprx_torch.graph.fast_stream import FastStreamDriver

torch.set_num_threads(1)

CFG = PprConfig(alpha=0.2, eps=1e-8, max_rounds=10_000)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    n = 35
    src, dst, _ = synthetic_powerlaw_stream(n, 500, seed=11)
    a = JaxDriver(
        src, dst, n, [0, 6, 17], CFG, StreamConfig(window=250, slide=25),
        dtype=jnp.float64, rebuild_every=3, e_top=64, n_tiers=3, segsum=False,
    )
    a.seed()
    list(a.run(3))
    path = str(tmp_path / "fast.npz")
    save_checkpoint(path, a)
    b = FastStreamDriver.from_checkpoint(path, src, dst, device="cpu")
    assert (b.head, b.fcnt, b.step_idx, b.tiers) == (a.head, a.fcnt, a.step_idx, a.tiers)
    assert b.state.p.dtype == torch.float64

    ra = [int(s.rounds) for s in a.run(3)]
    rb = [s.rounds for s in b.run(3)]
    assert ra == rb
    np.testing.assert_allclose(b.state.p.numpy(), np.asarray(a.state.p), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.state.r.numpy(), np.asarray(a.state.r), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(b.graph.window.deg.numpy(), np.asarray(a.graph.window.deg))
    np.testing.assert_array_equal(b.hsrc, a.hsrc)


def test_state_from_arrays_keeps_dtype_and_mode():
    p = np.arange(6, dtype=np.float32).reshape(3, 2)
    st = state_from_arrays(p, -p, FORWARD, device="cpu")
    assert st.p.dtype == torch.float32 and st.mode == FORWARD
    np.testing.assert_array_equal(st.r.numpy(), -p)
