"""The port's runtime leaves process-wide state as it found it.

Both runtimes read their configuration from ``RTPU_<FLAG>`` variables,
and tier-1 runs port and reference tests one after another in the same
xdist worker. The reference's ``init_driver`` leaves
``RTPU_FLIGHT_RECORDER_ENABLED=1`` behind, so the port's ``init`` that
follows turns its own recorder on; ``shutdown`` must turn it off again
and put back the ``RTPU_FLIGHT_*`` variables (set or popped) as they
were. The refsan ledger a session enabled goes with the session too.
No test here starts the reference's runtime.
"""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch.devtools import refsan
from ray_tpu_torch.util import flight_recorder as tfr

FLAGS = ("RTPU_FLIGHT_RECORDER_ENABLED", "RTPU_FLIGHT_RECORDER_CAPACITY",
         "RTPU_FLIGHT_FLUSH_INTERVAL_S", "RAY_TPU_REFSAN")


@pytest.fixture
def clean_env():
    saved = {k: os.environ.get(k) for k in FLAGS}
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    for k in FLAGS:
        os.environ.pop(k, None)
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    tfr.disable()
    refsan.disable()


def _flags():
    return {k: os.environ.get(k) for k in FLAGS}


def _session(**system_config):
    ray_tpu_torch.init(num_cpus=1, system_config=system_config or None)
    on = tfr.enabled()
    ray_tpu_torch.shutdown()
    return on


def test_leftover_flag_does_not_outlive_shutdown(clean_env):
    # the reference's init_driver leaves this behind
    os.environ["RTPU_FLIGHT_RECORDER_ENABLED"] = "1"
    before = _flags()
    assert _session() is True  # the shared flag names turn it on ...
    assert tfr.RECORDER is None and not tfr.enabled()  # ... not after
    assert tfr._flusher is None
    assert _flags() == before


def test_configured_recorder_is_off_and_env_unset_after(clean_env):
    before = _flags()
    assert _session(flight_recorder_enabled=True,
                    flight_recorder_capacity=64) is True
    assert tfr.RECORDER is None
    assert _flags() == before  # nothing of the session's flags is left


def test_popped_flag_comes_back(clean_env):
    # a disabled session pops the enabled flag for its workers; the
    # value the process had before init is restored at shutdown
    os.environ["RTPU_FLIGHT_RECORDER_ENABLED"] = "0"
    os.environ["RTPU_FLIGHT_FLUSH_INTERVAL_S"] = "0.5"
    before = _flags()
    assert _session() is False
    assert _flags() == before


def test_two_sessions_in_a_row_restore_the_first_state(clean_env):
    os.environ["RTPU_FLIGHT_RECORDER_ENABLED"] = "1"
    before = _flags()
    _session(flight_recorder_capacity=32)
    _session(flight_flush_interval_s=0.05)
    assert _flags() == before and tfr.RECORDER is None


def test_refsan_ledger_ends_with_the_session(clean_env):
    os.environ["RAY_TPU_REFSAN"] = "1"
    ray_tpu_torch.init(num_cpus=1)
    assert refsan.LEDGER is not None
    ref = ray_tpu_torch.put(b"x" * 10)
    assert ray_tpu_torch.get(ref) == b"x" * 10
    del ref
    ray_tpu_torch.shutdown()
    assert refsan.LEDGER is None and refsan._flusher is None
    assert isinstance(refsan.report(), list)  # findings stay readable
