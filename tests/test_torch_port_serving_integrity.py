"""The port's integrity sentinels and device-loss recovery against the
reference, on the CPU.

``finite_verdict`` (a torch reduction in the port, a jnp one in the
reference), ``degenerate_frames``, ``invalid_members``, ``enforce`` and
``poison`` get the same arrays and must give the same verdicts.
``classify_device_loss`` gets the reference's exception cases with the
same verdicts, plus the port's own CUDA cases (``torch.AcceleratorError``,
the CUDA driver's messages) as losses and ``torch.OutOfMemoryError`` as
none. ``DeviceRecoveryManager`` runs the reference's scripts (recovery,
warm failure, permanent loss and its hook, the retry budget, the kill
switch) in both packages with the same outcomes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cassmantle_tpu import chaos as jchaos
from cassmantle_tpu.serving import device_recovery as jdr
from cassmantle_tpu.serving import integrity as jintegrity
from cassmantle_tpu.serving.queue import DeadlineExceeded as JDeadline
from cassmantle_tpu.serving.queue import QueueFull as JQueueFull
from cassmantle_tpu.utils.retry import RetryBudget as JBudget
from cassmantle_tpu_torch import chaos as pchaos
from cassmantle_tpu_torch.serving import device_recovery as pdr
from cassmantle_tpu_torch.serving import integrity as pintegrity
from cassmantle_tpu_torch.serving.queue import DeadlineExceeded as PDeadline
from cassmantle_tpu_torch.serving.queue import QueueFull as PQueueFull
from cassmantle_tpu_torch.utils.retry import RetryBudget as PBudget

import _torch_port_common  # noqa: F401 (caps torch's threads under xdist)


def _arrays():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((5, 3, 4)).astype(np.float32)
    x[1, 2, 3] = np.nan
    x[3, 0, 0] = np.inf
    flat = rng.standard_normal((6,)).astype(np.float32)
    flat[4] = -np.inf
    return {"batch": x, "flat": flat,
            "ints": np.arange(12, dtype=np.int32).reshape(4, 3)}


@pytest.mark.parametrize("name", ["batch", "flat", "ints"])
def test_finite_verdict_matches_reference(name):
    arr = _arrays()[name]
    ref = np.asarray(jintegrity.finite_verdict(jnp.asarray(arr)))
    got = pintegrity.finite_verdict(torch.from_numpy(arr))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)


def _frames():
    rng = np.random.default_rng(32)
    u8 = rng.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)
    u8[1] = 0
    u8[3] = 117
    return u8


def test_degenerate_frames_and_invalid_members_match_reference():
    u8 = _frames()
    np.testing.assert_array_equal(pintegrity.degenerate_frames(u8),
                                  jintegrity.degenerate_frames(u8))
    verdict = np.array([True, True, False, True])
    for n in (None, 2, 4):
        for images in (None, u8):
            ref = jintegrity.invalid_members(verdict, images=images, n=n)
            got = pintegrity.invalid_members(verdict, images=images, n=n)
            np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        pintegrity.invalid_members(torch.from_numpy(verdict), images=u8),
        jintegrity.invalid_members(verdict, images=u8))
    empty = np.zeros((0, 4, 4, 3), np.uint8)
    np.testing.assert_array_equal(pintegrity.degenerate_frames(empty),
                                  jintegrity.degenerate_frames(empty))


def test_enforce_and_the_kill_switch_match_reference(monkeypatch):
    u8 = _frames()
    errors = []
    for mod in (jintegrity, pintegrity):
        with pytest.raises(mod.OutputInvalid) as exc:
            mod.enforce(np.ones(4, bool), pipeline="t2i", stage="sample",
                        images=u8)
        errors.append((exc.value.pipeline, exc.value.stage,
                       exc.value.members, str(exc.value)))
        mod.enforce(np.ones(4, bool), pipeline="t2i", stage="sample",
                    images=u8[[0, 2]])
    assert errors[0] == errors[1] and errors[1][2] == (1, 3)
    monkeypatch.setenv("CASSMANTLE_NO_INTEGRITY_CHECKS", "1")
    for mod in (jintegrity, pintegrity):
        assert mod.integrity_disabled()
        mod.enforce(np.zeros(4, bool), pipeline="t2i", stage="sample",
                    images=u8)


@pytest.mark.parametrize("name", ["batch", "ints", "frames"])
def test_poison_corrupts_the_references_member(name):
    arr = _frames() if name == "frames" else _arrays()[name]
    outs = []
    for chaos, mod in ((jchaos, jintegrity), (pchaos, pintegrity)):
        chaos.configure("seed=1;device.poison=raise:peer=scorer,times=1")
        try:
            untouched = mod.poison(arr, peer="t2i", member=2)
            hit = mod.poison(arr, peer="scorer", member=2)
            after = mod.poison(arr, peer="scorer", member=2)
        finally:
            chaos.disarm()
        assert untouched is arr and after is arr
        outs.append(hit)
    np.testing.assert_array_equal(outs[1], outs[0])
    assert not np.array_equal(outs[1], arr)
    # a device tensor: the same member corrupted in place of a copy
    pchaos.configure("seed=1;device.poison=raise:peer=scorer,times=1")
    try:
        t = pintegrity.poison(torch.from_numpy(arr), peer="scorer",
                              member=2)
    finally:
        pchaos.disarm()
    np.testing.assert_array_equal(t.numpy(), outs[0])


# -- device-loss classification -------------------------------------------------

class XlaRuntimeError(Exception):
    pass


class AcceleratorError(RuntimeError):
    pass


class CudaError(RuntimeError):
    """A look-alike of ``torch.cuda.CudaError`` (which needs the CUDA
    runtime to be made)."""


def _chained():
    outer = RuntimeError("dispatch failed")
    outer.__cause__ = XlaRuntimeError("device is lost")
    a, b = RuntimeError("a"), RuntimeError("b")
    a.__cause__, b.__cause__ = b, a
    return outer, a


REFERENCE_CASES = [
    XlaRuntimeError("boom"),
    RuntimeError("TPU driver: data transfer failed"),
    RuntimeError("chaos: injected failure at device.lost"),
    *_chained(),
    ValueError("bad shape"),
    pintegrity.OutputInvalid("t2i", "sample"),
]


@pytest.mark.parametrize("i", range(len(REFERENCE_CASES)))
def test_classifier_matches_reference_on_its_cases(i):
    exc = REFERENCE_CASES[i]
    assert (pdr.classify_device_loss(exc) is None) == \
        (jdr.classify_device_loss(exc) is None)
    assert pdr.classify_device_loss(exc) == jdr.classify_device_loss(exc)


def test_classifier_conservative_like_reference():
    for exc in (JDeadline("score"), PDeadline("score"), JQueueFull("score"),
                PQueueFull("score"),
                jintegrity.OutputInvalid("t2i", "sample")):
        assert pdr.classify_device_loss(exc) is None
        assert jdr.classify_device_loss(exc) is None


CUDA_LOSSES = [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: device-side assert triggered\nCUDA kernel errors might be "
    "asynchronously reported",
    "CUDA error: unspecified launch failure",
    "CUDA error: uncorrectable ECC error encountered",
    "CUDA driver version is insufficient for CUDA runtime version",
    "CUDA error: device not ready",
    "CUDA error: misaligned address",
]


@pytest.mark.parametrize("msg", CUDA_LOSSES)
def test_classifier_catches_cuda_losses(msg):
    """The port's CUDA markers, under a generic RuntimeError and wrapped
    in another exception's cause."""
    assert pdr.classify_device_loss(RuntimeError(msg)) is not None
    outer = RuntimeError("score dispatch failed")
    outer.__cause__ = RuntimeError(msg)
    assert pdr.classify_device_loss(outer) is not None


def test_classifier_cuda_types_and_oom():
    """torch's CUDA error types are losses by name; running out of device
    memory never is, whatever its message says."""
    assert pdr.classify_device_loss(AcceleratorError("x")) is not None
    if hasattr(torch, "AcceleratorError"):
        assert pdr.classify_device_loss(
            torch.AcceleratorError("CUDA error: an illegal memory access "
                                   "was encountered")) is not None
    assert pdr.classify_device_loss(CudaError("x")) is not None
    oom = torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 80.00 GiB (GPU 0; 79.11 GiB "
        "total capacity)")
    assert pdr.classify_device_loss(oom) is None
    wrapped = RuntimeError("generate failed")
    wrapped.__cause__ = oom
    assert pdr.classify_device_loss(wrapped) is None


# -- the recovery manager --------------------------------------------------------

class _FakeSupervisor:
    def __init__(self):
        self.lost = None
        self.events = []

    def note_device_lost(self, reason):
        self.lost = reason
        self.events.append(("lost", reason))

    def note_device_recovered(self):
        self.lost = None
        self.events.append(("recovered",))

    @property
    def device_lost(self):
        return self.lost


def _dead():
    raise RuntimeError("dead")


def _run(mod, budget_cls, script):
    sup = _FakeSupervisor()
    calls = []
    drained = []
    rebuild, warm, kw = script(calls)
    if "budget" in kw:
        kw["budget"] = budget_cls("t", capacity=kw["budget"],
                                  refill_per_s=0.0)
    mgr = mod.DeviceRecoveryManager(supervisor=sup, rebuild=rebuild,
                                    warm=warm, on_permanent=drained.append,
                                    backoff_s=0.0, sleep=lambda s: None,
                                    **kw)
    began = mgr.note_dispatch_exception(
        RuntimeError("chaos: injected failure at device.lost"))
    mgr.join(timeout=5.0)
    mgr.begin_recovery("again")
    mgr.join(timeout=5.0)
    return (began, calls, drained, mgr.permanent, mgr.recovering,
            [e[0] for e in sup.events], sup.lost is None)


SCRIPTS = {
    "recovers": lambda calls: (lambda: calls.append("rebuild"),
                               lambda: calls.append("warm"), {}),
    "warm_fails": lambda calls: (lambda: calls.append("rebuild"),
                                 _dead, {"max_attempts": 2}),
    "permanent": lambda calls: (lambda: calls.append("rebuild") or _dead(),
                                None, {"max_attempts": 3}),
    "budget": lambda calls: (lambda: calls.append("rebuild") or _dead(),
                             None, {"max_attempts": 10, "budget": 2.0}),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_recovery_manager_matches_reference(name):
    ref = _run(jdr, JBudget, SCRIPTS[name])
    port = _run(pdr, PBudget, SCRIPTS[name])
    assert port == ref


def test_recovery_kill_switch_matches_reference(monkeypatch):
    monkeypatch.setenv("CASSMANTLE_NO_DEVICE_RECOVERY", "1")
    outs = []
    for mod in (jdr, pdr):
        sup = _FakeSupervisor()
        rebuilt = []
        mgr = mod.DeviceRecoveryManager(supervisor=sup,
                                        rebuild=lambda: rebuilt.append(1))
        mgr.begin_recovery("operator")
        mgr.join(timeout=1.0)
        outs.append((sup.lost, rebuilt, mgr.recovering))
    assert outs[0] == outs[1] == ("operator", [], False)
