"""(t, l)-threshold Paillier (reference: thresholdkey.go,
thresholdkey_generator.go, safe_prime.go): safe primes, key generation
with verification keys, partial decryption, combining, and the
share-decryption zero-knowledge proofs.  The port of
``paillier_tpu.threshold``, on kernels B1 (partial decryption), B2
(Lagrange powers, proof ladders) and B4 (verification keys).

    import random
    from paillier_tpu_torch import Encryptor
    from paillier_tpu_torch.threshold import (ThresholdKeyGenerator,
                                              combine, partial_decrypt_all)
    keys = ThresholdKeyGenerator(2048, 5, 3, random.Random(1)).generate()
    ct = Encryptor(keys[0].public(), device="cuda").encrypt([7, 8])
    combine(keys[0].public(), partial_decrypt_all(keys[:3], ct))   # [7, 8]
"""

from .decrypt import (PartialDecryptionBatch, PartialDecryptionZKPBatch,
                      combine, combine_ints,
                      compute_lambda, go_div, L_int, lagrange_powers,
                      partial_decrypt, partial_decrypt_all,
                      partial_decrypt_int, verify_partial_decryptions)
from .keygen import (ThresholdKeyGenerator, compute_share,
                     generate_threshold_keys)
from .keys import (PartialDecryption, PartialDecryptionZKP,
                   ThresholdPublicKey, ThresholdSecretKey, from_reference)
from .safe_prime import SafePrimeTimeout, generate_safe_prime, is_safe_prime
from .zkp import (CombinedWithZKP, combine_with_zkp, combine_with_zkp_batch,
                  partial_decrypt_with_zkp, partial_decrypt_with_zkp_batch,
                  verify_decryption, verify_partial_decryption, verify_proof,
                  verify_proofs, verify_proofs_batch)

__all__ = ["PartialDecryptionBatch", "PartialDecryptionZKPBatch", "combine",
           "combine_ints", "compute_lambda", "go_div", "L_int",
           "lagrange_powers", "partial_decrypt", "partial_decrypt_all",
           "partial_decrypt_int", "verify_partial_decryptions",
           "ThresholdKeyGenerator", "compute_share", "generate_threshold_keys",
           "PartialDecryption", "PartialDecryptionZKP", "ThresholdPublicKey",
           "ThresholdSecretKey", "from_reference", "SafePrimeTimeout",
           "generate_safe_prime", "is_safe_prime", "CombinedWithZKP",
           "combine_with_zkp", "combine_with_zkp_batch",
           "partial_decrypt_with_zkp", "partial_decrypt_with_zkp_batch",
           "verify_decryption", "verify_partial_decryption", "verify_proof",
           "verify_proofs", "verify_proofs_batch"]
