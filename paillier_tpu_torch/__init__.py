"""paillier_tpu_torch: the PyTorch / CUDA port of paillier_tpu.

Paillier encryption on torch tensors, with the exponent ladder as a
hand-written CUDA kernel for NVIDIA Hopper (sm_90a).  The JAX package
``paillier_tpu`` is the reference it is held against, bit for bit; this
package never imports JAX.

Ported so far: key generation, regular encryption at level 1
(``Encryptor``) and CRT decryption at level 1 (``Decryptor(crt=True)``),
on the CPU (plain torch) or on a CUDA device (kernel B1, built from
``csrc/`` with nvcc at first use).  Every entry point takes an explicit
``device``.

    import random
    from paillier_tpu_torch import keygen, Encryptor, Decryptor
    sk, pk = keygen(2048, random.Random(1))
    ct = Encryptor(pk, device="cuda").encrypt([1, 2, 3])
    Decryptor(sk, crt=True, device="cuda").decrypt(ct)   # [1, 2, 3]
"""

from .core.decrypt import Decryptor
from .core.encrypt import Encryptor
from .core.keygen import keygen
from .core.keys import (LEVEL_ONE, REGULAR, Ciphertext, DeviceKey,
                        PublicKey, SecretKey)

__all__ = ["keygen", "Encryptor", "Decryptor", "Ciphertext", "DeviceKey",
           "PublicKey", "SecretKey", "LEVEL_ONE", "REGULAR"]
