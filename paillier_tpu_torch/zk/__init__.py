"""Zero-knowledge proofs: DDLEQ proofs of nested re-encryption
(:mod:`.ddleq`), the port of ``paillier_tpu.zk``."""
