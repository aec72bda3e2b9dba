"""The harness's own pieces: seeds, windows, traces and the registry of
configurations, cells, drivers and metric readers."""
