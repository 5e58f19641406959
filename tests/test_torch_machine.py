"""``repro_torch.core.machine.machine_fingerprint`` against the reference's:
the same stable host keys with the same values, jax's three keys mapped to
torch's (``jax`` -> ``torch`` and ``cuda``, ``jax_backend`` -> ``backend``,
``devices`` -> the cards' names, plus each card's ``power_limit``), equal
dicts from two calls, and the card asked for by default."""

import subprocess

import pytest
import torch

from repro.core import machine as ref_machine
from repro_torch.core import machine

HOST_KEYS = ("platform", "machine", "cpu_count", "python")


def test_keys_are_the_references_with_jax_mapped_to_torch():
    ref = ref_machine.machine_fingerprint()
    got = machine.machine_fingerprint("cpu")
    want = (set(ref) - {"jax", "jax_backend"}) | {"torch", "cuda", "backend", "power_limit"}
    assert set(got) == want
    assert {k: got[k] for k in HOST_KEYS} == {k: ref[k] for k in HOST_KEYS}
    assert got["torch"] == torch.__version__
    assert got["cuda"] == torch.version.cuda
    assert got["backend"] == "cpu"
    assert got["devices"] == [] and got["power_limit"] is None


def test_two_calls_give_equal_dicts():
    assert machine.machine_fingerprint("cpu") == machine.machine_fingerprint("cpu")


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        machine.machine_fingerprint()


def _fake_card(monkeypatch, smi):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(machine.subprocess, "run", smi)


def test_on_a_card_each_power_limit_comes_from_nvidia_smi(monkeypatch):
    out = "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 500.00 W\n"
    _fake_card(monkeypatch, lambda *a, **k: subprocess.CompletedProcess(a, 0, out, ""))
    got = machine.machine_fingerprint()
    assert got["backend"] == "cuda"
    assert got["devices"] == ["NVIDIA H100 80GB HBM3"] * 2
    assert got["power_limit"] == ["700.00 W", "500.00 W"]


def test_on_a_card_a_failing_nvidia_smi_raises(monkeypatch):
    def smi(cmd, **kw):
        raise subprocess.CalledProcessError(9, cmd)

    _fake_card(monkeypatch, smi)
    with pytest.raises(subprocess.CalledProcessError):
        machine.machine_fingerprint()
    _fake_card(monkeypatch, lambda *a, **k: subprocess.CompletedProcess(a, 0, "\n", ""))
    with pytest.raises(RuntimeError, match="no card"):
        machine.machine_fingerprint()
