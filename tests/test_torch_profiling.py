"""The port's profiling helpers (utils/profiling.py) on the CPU: `timed`
prints the JAX package's line as a context manager and as a decorator,
`device_trace` writes a Chrome trace of a CPU window, and `roofline` and
`bound` give the card's two limits by name."""

import json
import re

import pytest


@pytest.mark.parametrize("form", ["context", "decorator"])
def test_timed_prints_the_reference_line(form, capsys):
    import torch

    from crypto12381_tpu_torch.utils import profiling as PR

    if form == "context":
        with PR.timed("keygen") as t:
            torch.ones(8).sum()
        assert t.elapsed_us > 0
        label = "keygen"
    else:
        @PR.timed()
        def work(n):
            return torch.arange(n) * 2

        assert work(4).tolist() == [0, 2, 4, 6]
        label = "work"
    out = capsys.readouterr()
    assert out.out == ""
    assert re.fullmatch(label + r": finish in \d+ μs\n", out.err)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    from crypto12381_tpu_torch.utils import profiling as PR

    with PR.device_trace(str(tmp_path / "trace")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert any("mm" in ev.name for ev in prof.events())
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


def test_roofline_and_bound_use_the_cards_limits():
    from crypto12381_tpu_torch.utils import profiling as PR

    assert PR.HBM_BYTES_PER_S == 3.35e12
    assert PR.INT32_MULADDS_PER_S == 132 * 64 * 1.98e9
    assert PR.bound(3.35e12, 0) == (1.0, "bytes")
    assert PR.bound(0, 2 * PR.INT32_MULADDS_PER_S) == (2.0, "operations")
    # one Fp product (588 multiply-adds, 144 bytes) on 2^20 rows in 1 ms
    rec = PR.roofline("fp_mont_mul", 1 << 20, 1e-3, 588, 144)
    assert set(rec) == {"kernel", "rate_per_s", "int32_muladds_per_s", "hbm_bytes_per_s",
                        "int32_frac_of_peak", "hbm_frac_of_peak", "bound_s", "bound_by",
                        "frac_of_bound"}
    assert rec["rate_per_s"] == (1 << 20) * 1e3
    assert rec["int32_frac_of_peak"] == pytest.approx(588 * (1 << 20) * 1e3 / PR.INT32_MULADDS_PER_S)
    assert rec["hbm_frac_of_peak"] == pytest.approx(144 * (1 << 20) * 1e3 / PR.HBM_BYTES_PER_S)
    assert rec["bound_by"] == "bytes"                   # K1 is bound by its bytes
    assert rec["frac_of_bound"] == pytest.approx(rec["bound_s"] / 1e-3)
