"""Aux subsystem tests: stage timing + structured logging."""

import io
import json

from text2video.utils.logging import JsonLogger
from text2video.utils.profiling import StageTimer, device_trace


def test_stage_timer_totals_and_report():
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("b"):
        with t.stage("a"):
            pass
    totals = t.totals()
    assert set(totals) == {"a", "b"}
    assert totals["a"] >= 0 and totals["b"] >= totals["a"] / 2 - 1
    rep = t.report()
    assert "a" in rep and "ms" in rep


def test_json_logger_stream():
    buf = io.StringIO()
    log = JsonLogger(stream=buf)
    log.log("unit_test", value=3, name="x")
    rec = json.loads(buf.getvalue())
    assert rec["event"] == "unit_test" and rec["value"] == 3
    assert "ts" in rec


def test_json_logger_file(tmp_path):
    path = str(tmp_path / "log.jsonl")
    log = JsonLogger(path=path)
    log.log("e1", a=1)
    log.log("e2", b=2)
    log.close()
    lines = [json.loads(l) for l in open(path)]
    assert [r["event"] for r in lines] == ["e1", "e2"]


def test_device_trace_noop():
    with device_trace(None):
        x = 1
    assert x == 1
