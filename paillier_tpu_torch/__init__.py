"""paillier_tpu_torch: the PyTorch / CUDA port of paillier_tpu.

Paillier / Damgard-Jurik encryption on torch tensors, with the exponent
ladders as hand-written CUDA kernels for NVIDIA Hopper (sm_90a).  The JAX
package ``paillier_tpu`` is the reference it is held against, bit for
bit; this package never imports JAX.

Ported: key generation (with the device-batched prime search), regular
and alternative encryption at levels 1 and 2 and nested encryption,
generic decryption at levels 1 and 2, CRT decryption at level 1 and
nested decryption, the homomorphic operations (``homomorphic.add``,
``sub``, ``const_mult``, ``randomize``, ``aggregate``,
``aggregate_streaming``, the nested ones), ``extract_randomness``,
(t, l)-threshold Paillier (:mod:`.threshold`: keys, partial decryption,
combining, the share-decryption proofs with a batched SHA-256; the JAX
root's threshold names are exported here too), DDLEQ
proofs of nested re-encryption (:mod:`.zk.ddleq`), fixed-point
encoding, serialization, the CLI (``python -m paillier_tpu_torch.cli``)
and multi-device sharding on ``torch.distributed`` (:mod:`.parallel`:
``make_mesh``, ``shard_batch``, ``sharded_aggregate``,
``distributed_combine``, DDLEQ's ``mesh=``), on the CPU (plain torch) or on a CUDA device
(kernels B1-B4, built from ``csrc/`` with nvcc at first use).  The
names are the JAX package's.  Entry points that make ciphertexts take
an explicit ``device``; the homomorphic operations and the proofs work
on the device of their ciphertexts; the device prime search runs on
the card unless given ``device="cpu"``.

    import random
    from paillier_tpu_torch import (Ciphertext, Decryptor, Encryptor,
                                    homomorphic, keygen)
    sk, pk = keygen(2048, random.Random(1), device_primes=False)
    ct = Encryptor(pk, device="cuda").encrypt([1, 2, 3])
    total = homomorphic.aggregate(pk, ct)
    Decryptor(sk, crt=True, device="cuda").decrypt(
        Ciphertext(c=total.c[None]))                      # [6]
"""

from .bigint import host, montgomery, vpu
from .config import Config, get_config, set_config
from . import threshold
from .core import homomorphic
from .core.decrypt import Decryptor, decrypt_nested_layer, nested_decrypt
from .core.encrypt import Encryptor, nested_encrypt
from .core.keygen import device_batched_prime, keygen
from .core.keys import (ALTERNATIVE, DEFAULT_LEVEL, LEVEL_ONE, LEVEL_TWO,
                        MIXED, REGULAR, Ciphertext, DeviceKey, PublicKey,
                        SecretKey, decode_batch, encode_batch)
from .ops import encoding, oracle, serialize
from .ops.encoding import (decode_fixed_point, decode_signed,
                           encode_fixed_point, encode_signed)
from .ops.serialize import (ciphertext_from_bytes, ciphertext_to_bytes,
                            key_from_json, public_key_to_json)
from .parallel import collective, mesh
from .parallel.collective import distributed_combine, sharded_aggregate
from .parallel.mesh import make_mesh, shard_batch
from .threshold.decrypt import (combine, combine_ints, partial_decrypt,
                                partial_decrypt_int)
from .threshold.keygen import ThresholdKeyGenerator, generate_threshold_keys
from .threshold.keys import (PartialDecryption, PartialDecryptionZKP,
                             ThresholdPublicKey, ThresholdSecretKey)
from .threshold.safe_prime import generate_safe_prime, is_safe_prime
from .threshold.zkp import (combine_with_zkp, partial_decrypt_with_zkp,
                            verify_decryption, verify_proof)
from .zk.ddleq import DDLEQProof
from .zk.ddleq import prove as prove_ddleq
from .zk.ddleq import verify as verify_ddleq

__all__ = ["host", "montgomery", "vpu", "Config", "get_config", "set_config",
           "threshold", "homomorphic", "Decryptor", "decrypt_nested_layer",
           "nested_decrypt", "Encryptor", "nested_encrypt",
           "device_batched_prime", "keygen",
           "ALTERNATIVE", "DEFAULT_LEVEL", "LEVEL_ONE", "LEVEL_TWO", "MIXED",
           "REGULAR", "Ciphertext", "DeviceKey", "PublicKey", "SecretKey",
           "decode_batch", "encode_batch", "encoding", "oracle",
           "serialize", "decode_fixed_point", "decode_signed",
           "encode_fixed_point", "encode_signed", "ciphertext_from_bytes",
           "ciphertext_to_bytes", "key_from_json", "public_key_to_json",
           "DDLEQProof", "prove_ddleq", "verify_ddleq",
           "collective", "mesh", "distributed_combine", "make_mesh",
           "shard_batch", "sharded_aggregate", "combine", "combine_ints",
           "partial_decrypt", "partial_decrypt_int", "ThresholdKeyGenerator",
           "generate_threshold_keys", "PartialDecryption",
           "PartialDecryptionZKP", "ThresholdPublicKey", "ThresholdSecretKey",
           "generate_safe_prime", "is_safe_prime", "combine_with_zkp",
           "partial_decrypt_with_zkp", "verify_decryption", "verify_proof"]

__version__ = "0.1.0"
