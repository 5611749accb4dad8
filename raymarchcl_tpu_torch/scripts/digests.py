"""The sha256 of the frames the port renders on the card, which a change of
K1, K2 or K2c must keep, and the helper that computes them.

Each entry is (sha256 of the accum's float32 bytes, sha256 of the packed
image's uint32 bytes) of one frame on the H100, from a zeroed accum, MC
tables seed 0, over the volume's brick table (the same frame without it):

- "ao": the main path, gyroid 256^3, 512x512, 16 spp, `ao` preset, orbit
  camera theta=135 (scripts/bench.py's default, chip_smoke.py);
- "metal": the same frame with the `metal` preset (the reflective path);
- "config 1" to "config 4": BASELINE configs 1-4 at full spp
  (scripts/run_configs.py, chip_smoke.py);
- "config 5": BASELINE config 5 at its 100 spp (chip_smoke.py,
  scripts/run_config5.py); "config 5 at 4 spp": the same frame at the
  100 // 25 = 4 spp that scripts/run_configs.py renders, as the JAX
  package's script does.

The JAX package's frames are not these: XLA:CPU rounds a few operations
otherwise, and the port is held to it by tolerance (tests/test_torch_*).
"""

from __future__ import annotations

import hashlib

DIGESTS = {
    "ao": ("9bc114369f0d911035596f596547b3ffdf5f2fecb8bf955082f68d3838730aec",
           "b2e91f8672da0085f452fe2f88e8def9e16409936f970f89a9fceef66e21f04e"),
    "metal": ("e52f586bdca0a2a127636bbc26457092f24e8633aa24feb01b4191283184ef9d",
              "7a258f1839939e3c7d7e1d97f3433a3ba09e6346cedf593cce5ef419e61cd968"),
    "config 1": ("6cab0f3335c157c6cf71f2d769412ab03866fd45420c3131712cfc09c1f69402",
                 "ac6790c1e128aa92c4affb049e0eaa6b49d13a61e7b6385cb99d9fbf1ea50465"),
    "config 2": ("ec3e34162d3aebf0a8ea99ea4ae6f57ef3f606aba9d69c286c23d03c91793671",
                 "b4df5bbea08a10ab405decfd955d5f6d567f5001292581a786ca43d321f44b06"),
    "config 3": ("aca7a46002e58b4e3e909c0d765f510c2cae9cdfc7d72a1dc85e28954b982b68",
                 "910dc40e2e475085c2455252dd9ddfe0a198be09b66a6794686388b34dab634f"),
    "config 4": ("85a42e91f94c0d8ae7466ed3258a6711d916b64ad6d9ca8ddbf4c308e865f1d0",
                 "5081d3574782a6339b7d13f4573cfc0d4a8f51e0dcbf21bdb78e5ef081e57e78"),
    "config 5": ("fcde6900d75463592554e9d6e06af740a8ae2f7336d617ec03145a2dac7fdb07",
                 "55ebde83f48a1c6fced3da9a11673e2141823548446408301aa3fe1fa055520f"),
    "config 5 at 4 spp": ("acaddd91d9c7d940defe5ad1c9f952ed9e74151f4cd18dab261a40bd83924277",
                          "f5a466c04740bbf93dd2986f0aa0fa09cea8fbf6bef47b393dccebdf662f7cb1"),
}


def frame_digests(accum, argb) -> tuple:
    """(sha256 of accum's bytes, sha256 of argb's bytes); each a tensor on
    any device or a numpy array."""
    def sha(a):
        a = a.cpu().numpy() if hasattr(a, "cpu") else a
        return hashlib.sha256(a.tobytes()).hexdigest()

    return sha(accum), sha(argb)
