"""Execution layer: chunked streaming executor over device-resident
chunks, host-exact replay (CpuReCheck analog) and the host-exact tier."""
