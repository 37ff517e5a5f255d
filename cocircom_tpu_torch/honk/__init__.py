"""UltraHonk (plain) and co-UltraHonk — the Barretenberg-compatible Honk
proof system family behind co-noir.

Parity map (reference -> here):
  upstream co-noir/ultrahonk/src/transcript.rs      -> transcript.py
  upstream co-noir/ultrahonk/src/parse/builder.rs   -> builder.py
  upstream co-noir/ultrahonk/src/parse/proving_key.rs -> proving_key.py
  upstream co-noir/ultrahonk/src/oink/              -> prover.py (oink rounds)
  upstream co-noir/ultrahonk/src/decider/           -> sumcheck.py, zeromorph.py, relations.py
  upstream co-noir/ultrahonk/src/prover.rs          -> prover.py
  upstream co-noir/co-ultrahonk/src/                -> co_prover.py, co_alg.py, co_builder.py
"""
