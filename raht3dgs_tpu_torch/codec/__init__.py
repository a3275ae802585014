"""Host entropy coding (RLGR) and the R3TC frame container."""
