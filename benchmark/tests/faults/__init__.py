"""The faults that a run of each traffic kind can have, one module per
kind, `<kind>.py`, found by the kind's name: its `FAULTS` each break the
timed path underneath with pytest's monkeypatch
(`test_bench_faults.py`)."""
