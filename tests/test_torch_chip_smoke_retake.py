"""chip_smoke.py's profiler-read checks take their trace again, up to three
traces, when a kernel name they want is missing or a count falls short
(`retaken`, `kernel_names`, `profiled`), on the CPU through stub traces:
a trace that misses once passes on the retake and prints one line naming
the phase and what was missing; one that misses three times fails."""

import pytest
import torch

import chip_smoke

WANT = ["attn_fwd_mma_kernel"]


def _stub_traces(monkeypatch, name, traces):
    taken = []

    def take(*args):
        taken.append(args)
        return traces[min(len(taken), len(traces)) - 1]

    monkeypatch.setattr(chip_smoke, name, take)
    return taken


@pytest.mark.parametrize("first", [set(), {"attn_fwd_tf32x3_kernel"}],
                         ids=["empty", "partial"])
def test_a_name_missing_once_passes_on_the_retake(monkeypatch, capsys,
                                                  first):
    taken = _stub_traces(monkeypatch, "traced_kernels",
                         [first, {"attn_fwd_mma_kernel", "elementwise"}])
    chip_smoke.kernel_names("7", "packed (B7)", None, torch.bfloat16,
                            "attn_fwd", WANT)
    out = capsys.readouterr().out
    assert len(taken) == 2
    assert out.count("taking it again") == 1
    assert "phase 7: packed (B7) torch.bfloat16: the profiler trace lacks " \
           "attn_fwd_mma_kernel; taking it again (2 of 3)" in out


def test_a_name_missing_three_times_fails(monkeypatch, capsys):
    taken = _stub_traces(monkeypatch, "traced_kernels",
                         [{"attn_fwd_tf32x3_kernel"}])
    with pytest.raises(AssertionError, match="want"):
        chip_smoke.kernel_names("7", "packed (B7)", None, torch.bfloat16,
                                "attn_fwd", WANT)
    assert len(taken) == 3
    assert capsys.readouterr().out.count("taking it again") == 2


def test_a_trace_that_holds_the_names_is_taken_once(monkeypatch, capsys):
    taken = _stub_traces(monkeypatch, "traced_kernels",
                         [{"attn_fwd_mma_kernel"}])
    chip_smoke.kernel_names("7", "x", None, torch.bfloat16, "attn_fwd",
                            WANT)
    assert len(taken) == 1 and "again" not in capsys.readouterr().out


def test_profiled_retakes_until_the_wanted_kernels_are_there(monkeypatch):
    """Phase 22's B9 names: a trace missing one of the three kernels is
    taken again; with nothing wanted, only an empty trace is."""
    want = chip_smoke.B9_KERNELS[torch.bfloat16]
    full = {k: (0.1, 1.0) for k in want}
    part = dict(list(full.items())[:2])
    taken = _stub_traces(monkeypatch, "profile_kernels", [{}, part, full])
    assert chip_smoke.profiled(None, 5, "22", "B9", want) == full
    assert len(taken) == 3
    taken = _stub_traces(monkeypatch, "profile_kernels", [{}, part, full])
    assert chip_smoke.profiled(None) == part and len(taken) == 2
    taken = _stub_traces(monkeypatch, "profile_kernels", [part])
    assert chip_smoke.profiled(None, 5, "22", "B9", want) == part
    assert len(taken) == 3                 # the caller's check then fails


def test_short_counts_are_taken_again(capsys):
    """Phase 29's launches by role: a trace with fewer launches than the
    counters is taken again, and the last of three is returned as it is."""
    traces = iter([{"dq_plain": 5}, {"dq_plain": 6}])
    got = chip_smoke.retaken(
        "29", "plain: the profiled bf16 step", lambda: next(traces),
        lambda t: "" if t["dq_plain"] >= 6 else
        f"dq_plain {t['dq_plain']} of 6")
    assert got == {"dq_plain": 6}
    assert "phase 29: plain: the profiled bf16 step: the profiler trace " \
           "lacks dq_plain 5 of 6" in capsys.readouterr().out
    calls = []
    got = chip_smoke.retaken("29", "x", lambda: calls.append(1) or 5,
                             lambda t: "short")
    assert got == 5 and len(calls) == chip_smoke.TRACE_TAKES == 3
