"""The benchmark of fac_via_ppg_torch on the H100 (see README.md)."""
