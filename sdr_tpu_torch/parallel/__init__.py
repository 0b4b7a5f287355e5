"""The parallel layer: channel DP, time sharding, station-sharded wideband
and multi-process feeding (port of sdr_tpu/parallel/; see mesh.py)."""
