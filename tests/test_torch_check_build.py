"""tpudist_torch.check_build: tpudist's probes, lines and exit codes.

On this CPU host ``main()`` exits 0: the torch backend and the
collectives (one gloo rank) are OK, the kernel probe WARNs (it needs a
CUDA device) and the native probes are OK.  With a card faked present
the kernel probe is required: here it fails for real (no ``nvcc``), so
``main()`` prints ``[FAIL]`` and exits 1 — a broken kernel stack cannot
pass quietly; a card of another compute capability FAILs the backend
probe.
"""

import re

import pytest

LINE = re.compile(r"\[(OK  |FAIL|WARN)\] (.+?)  +(.*)$")


def _probes(out: str) -> dict:
    got = {}
    for line in out.splitlines():
        m = LINE.match(line)
        if m:
            got[m.group(2).strip()] = (m.group(1).strip(), m.group(3))
    return got


def _fake_card(monkeypatch, capability):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=0: capability)


def _no_nvcc():
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed")


@pytest.mark.parametrize("case", ["cpu_host", "card_kernels_broken",
                                  "card_wrong_capability"])
def test_check_build(case, monkeypatch, capsys):
    from tpudist_torch import check_build

    if case != "cpu_host":
        _fake_card(monkeypatch, (9, 0) if case == "card_kernels_broken"
                   else (8, 0))
        # one NCCL rank a card cannot form on a faked card
        monkeypatch.setattr(check_build, "_collectives",
                            lambda: "all_reduce (faked card)")
        monkeypatch.setattr("tpudist_torch.ops._cuda._nvcc", _no_nvcc)
    rc = check_build.main([])
    out = capsys.readouterr().out
    probes = _probes(out)
    assert list(probes)[:3] == ["torch backend", "collectives", "kernels"]
    assert probes["multi-host bootstrap"][0] == "OK"
    if case == "cpu_host":
        assert rc == 0
        assert probes["torch backend"][0] == "OK"
        assert "cpu" in probes["torch backend"][1]
        assert probes["collectives"] == (
            "OK", "all_reduce over 1 cpu rank (gloo)")
        assert probes["kernels"][0] == "WARN"
        assert "needs a CUDA device" in probes["kernels"][1]
        assert all(probes[n][0] == "OK" for n in (
            "native library", "native coordination service",
            "native data loader"))
        assert out.strip().splitlines()[-1] == (
            "tpudist check-build: all required subsystems available")
    else:
        assert rc == 1
        assert probes["kernels"][0] == "FAIL"
        assert "nvcc" in probes["kernels"][1]
        want = "OK" if case == "card_kernels_broken" else "FAIL"
        assert probes["torch backend"][0] == want
        if want == "FAIL":
            assert "9.0" in probes["torch backend"][1]
        assert out.strip().splitlines()[-1] == (
            "tpudist check-build: FAILED (required subsystem broken)")
