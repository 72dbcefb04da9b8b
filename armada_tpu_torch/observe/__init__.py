"""Round observatory: the host-device transfer ledger (`ledger`) and the
fairness ledger, preemption attribution and starvation tracker
(`fairness`)."""
