"""Helpers shared by the port's parity tests (tests/test_torch_port_*.py).

Reference parameter trees come from the Flax module's ``init``, traced
abstractly (``jax.eval_shape``: the tree and its shapes, without running
Flax's initializers, which take tens of seconds at CPU-test sizes), with
values drawn from a seeded numpy generator: kernels lecun-normal, biases
and norm scales perturbed away from the trivial zeros and ones so their
mapping is exercised. The same numpy arrays feed both sides.

Under pytest-xdist, importing this module caps torch's intra-op threads
at the worker's share of the host's cores (``cap_torch_threads``): each
worker's torch otherwise starts a thread per core, and six workers'
spinning OpenMP pools on one host spend most of the CPU waiting on each
other (the port's four slowest files took 777 s under ``-n 4`` uncapped,
175 s capped at two threads each, on an 8-core host).
"""

import os
import types

import jax
import numpy as np
import torch

from cassmantle_tpu_torch.models.weights import from_jax, state_dict_from_tree
from cassmantle_tpu_torch.ops.graphs import CapturedStep


def cap_torch_threads():
    """Under xdist, torch's intra-op threads: the host's cores over the
    workers (at least 1); outside xdist, torch's default."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


cap_torch_threads()


def jax_params(module, seed, *args, method=None):
    """A numpy parameter tree for Flax ``module`` called on ``args``."""
    kw = {} if method is None else {"method": method}
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0),
                                                   *a, **kw), *args)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        noise = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return noise / np.float32(np.sqrt(np.prod(shape[:-1])))
        if name == "scale":
            return np.float32(1.0) + np.float32(0.05) * noise
        if name == "bias":
            return np.float32(0.05) * noise
        if name == "embedding":
            return noise / np.float32(np.sqrt(shape[-1]))
        return np.float32(0.02) * noise              # position tables

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load(module, params, kind=None):
    """Port ``module`` with the reference tree ``params`` loaded, in eval."""
    sd = from_jax(kind, params) if kind else state_dict_from_tree(params)
    module.load_state_dict(sd)
    return module.eval()


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_rel(port, ref, tol):
    """max |port - ref| <= tol * max |ref|."""
    port, ref = to_numpy(port), to_numpy(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port.astype(np.float64) - ref).max() / max(
        np.abs(ref).max(), 1e-30)
    assert err <= tol, f"relative error {err:.3g} > {tol}"


def assert_grads(got, ref, tol=1e-4, zero=1e-6):
    """Gradients by name (port tensors, reference tensors): each within
    ``tol`` of its largest reference value (``assert_rel``). A gradient
    that is zero in exact arithmetic (the bias of a layer a GroupNorm
    follows; a key bias, which shifts every logit of a row alike) holds
    rounding only on both sides, ~1e-9: where the reference's is below
    ``zero`` of the model's largest gradient, the port's must be too."""
    assert set(got) == set(ref)
    top = max(float(np.abs(to_numpy(g)).max()) for g in ref.values())
    n_zero = 0
    for name in ref:
        assert got[name] is not None, name
        if float(np.abs(to_numpy(ref[name])).max()) < zero * top:
            n_zero += 1
            assert float(np.abs(to_numpy(got[name])).max()) < zero * top, \
                name
        else:
            assert_rel(got[name], ref[name], tol)
    assert n_zero < len(ref) // 4


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


class EagerStep(CapturedStep):
    """``CapturedStep`` without the graph, for the CPU: the "capture" runs
    the step's Python once, as a capture does (the wrappers count there),
    and a replay calls the step."""

    def _warm_up(self):
        self.fn()

    def _capture(self):
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0
        self.output = self.fn()
        self.graph = types.SimpleNamespace(replay=self.fn)
