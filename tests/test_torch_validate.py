"""``python -m tpufg_torch.validate`` against ``python -m tpufg.validate``
(CPU, the port's device monkeypatched to the CPU as the CLI's tests do).

Same arguments, same 64x64 synthetic source.  Compared: the exit codes
(0 PASS, 1 error, 2 FAIL) and the log lines, word for word once the
numbers are masked; the numbers within 1e-3 (the fast steps of the two
packages agree within 1 code, not bitwise, so the SSIMs of their outputs
differ in the 4th decimal: measured 0.888043 against 0.887901 in pyramid
mode; the exact steps are bitwise, tests/test_torch_exact.py).
"""

import contextlib
import io
import re

import pytest
import torch

import tpufg.validate as jvalidate
from tpufg_torch import validate

_NUM = re.compile(r"-?\d+\.\d+|\binf\b|\b\d+\b")


def _run(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    # drop the timestamp, keep "[LEVEL] message"
    lines = [re.sub(r"^\[[^\]]*\] ", "", ln)
             for ln in buf.getvalue().splitlines()]
    return rc, lines


def _split(lines):
    masked = [_NUM.sub("#", ln) for ln in lines]
    nums = [float(x) for ln in lines for x in _NUM.findall(ln)]
    return masked, nums


@pytest.mark.parametrize("argv,rc", [
    (["--frames", "2"], 0),
    (["--frames", "1", "--motion-mode", "none", "--threshold", "1.5"], 2),
    (["--frames", "0"], 1),
], ids=["pass", "fail", "one_frame"])
def test_validate_matches_tpufg(monkeypatch, argv, rc):
    monkeypatch.setattr(validate, "resolve_device",
                        lambda device: torch.device("cpu"))
    argv = ["synthetic:64x64", *argv]
    got_rc, got = _run(validate, argv)
    ref_rc, ref = _run(jvalidate, argv)
    assert got_rc == ref_rc == rc
    (got_m, got_n), (ref_m, ref_n) = _split(got), _split(ref)
    assert got_m == ref_m and len(got) >= 1
    assert got_n == pytest.approx(ref_n, abs=1e-3)
    if rc != 1:
        assert got[-1].endswith("PASS" if rc == 0 else "FAIL")


def test_validate_bad_source_is_an_error(monkeypatch, tmp_path):
    monkeypatch.setattr(validate, "resolve_device",
                        lambda device: torch.device("cpu"))
    argv = [str(tmp_path / "missing.raw"), "--input-width", "64",
            "--input-height", "64"]
    got_rc, got = _run(validate, argv)
    ref_rc, ref = _run(jvalidate, argv)
    assert got_rc == ref_rc == 1
    assert got == ref


def test_validate_needs_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    rc, lines = _run(validate, ["synthetic:64x64", "--frames", "1"])
    assert rc == 1
    assert "needs a CUDA device" in lines[-1]
