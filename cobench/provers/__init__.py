"""One module a kind of proof; a configuration names its module under `prover`."""
