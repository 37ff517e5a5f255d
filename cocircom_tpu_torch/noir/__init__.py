"""co-noir stack: ACIR ingestion, ACVM witness extension (plain + MPC),
and the UltraHonk proof system (plain + collaborative).

Reference layout (SURVEY.md section 2.4): co-noir/co-acvm (solver),
co-noir/ultrahonk (plain prover/verifier), co-noir/co-ultrahonk (MPC twin),
co-noir/co-noir (CLI).
"""
