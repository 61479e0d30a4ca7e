"""Entries: what a cell drives. `entries/<kind>.py` defines
`run(cell, device, trace_dir) -> Run`; a traffic mix names its kind."""
