"""Round observatory: the host-device transfer ledger (`ledger`)."""
