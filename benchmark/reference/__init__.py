"""The benchmark's plain reference: Paillier, threshold Paillier and DDLEQ
proofs in Python integers (with ``hashlib`` for the Fiat-Shamir oracle).

It imports nothing of the program under test (``paillier_tpu_torch``),
nothing of the JAX package and no torch: it works out again, from the
inputs the benchmark makes, every constant the program's set-up derives
(lambda, the CRT constants, the threshold shares), and judges the
program's outputs against its own answers.  The one encoding it shares
with the program, the prover's byte draws and the oracle's transcript,
is a frozen copy kept here.
"""
