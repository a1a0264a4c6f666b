"""Default colormap and the quantizer's lowest u16 value.

Host copy of ``thesia_tpu/render/colormap.py`` and of ``quantize_min_value``
(``thesia_tpu/render/visualize.py:17-27``); the port imports
nothing of the JAX package.  The original builds the table from
matplotlib's inferno data, which the port does not depend on: the same 258
RGB triples are stored here as hex, and ``tests/test_torch_images.py`` pins
them byte for byte against the original.

Table: black + matplotlib inferno-256 + white = 258 RGBA8 entries (reference:
src/prototypes/constants/colors.ts:64-165; length-258 expectation
src-tauri/src/core/mod.rs:55).
"""

from __future__ import annotations

import numpy as np

_RGB_HEX = (
    "00000000000401000501010601010802010a02020c02020e030210040312040314050417"
    "06041907051b08051d09061f0a07220b07240c08260d08290e092b10092d110a30120a32"
    "140b34150b37160b39180c3c190c3e1b0c411c0c431e0c451f0c48210c4a230c4c240c4f"
    "260c51280b53290b552b0b572d0b592f0a5b310a5c320a5e340a5f360961380962390963"
    "3b09643d09653e0966400a67420a68440a68450a69470b6a490b6a4a0c6b4c0c6b4d0d6c"
    "4f0d6c510e6c520e6d540f6d550f6d57106e59106e5a116e5c126e5d126e5f136e61136e"
    "62146e64156e65156e67166e69166e6a176e6c186e6d186e6f196e71196e721a6e741a6e"
    "751b6e771c6d781c6d7a1d6d7c1d6d7d1e6d7f1e6c801f6c82206c84206b85216b87216b"
    "88226a8a226a8c23698d23698f24699025689225689326679526679727669827669a2865"
    "9b29649d29649f2a63a02a63a22b62a32c61a52c60a62d60a82e5fa92e5eab2f5ead305d"
    "ae305cb0315bb1325ab3325ab43359b63458b73557b93556ba3655bc3754bd3853bf3952"
    "c03a51c13a50c33b4fc43c4ec63d4dc73e4cc83f4bca404acb4149cc4248ce4347cf4446"
    "d04545d24644d34743d44842d54a41d74b3fd84c3ed94d3dda4e3cdb503bdd513ade5238"
    "df5337e05536e15635e25734e35933e45a31e55c30e65d2fe75e2ee8602de9612bea632a"
    "eb6429eb6628ec6726ed6925ee6a24ef6c23ef6e21f06f20f1711ff1731df2741cf3761b"
    "f37819f47918f57b17f57d15f67e14f68013f78212f78410f8850ff8870ef8890cf98b0b"
    "f98c0af98e09fa9008fa9207fa9407fb9606fb9706fb9906fb9b06fb9d07fc9f07fca108"
    "fca309fca50afca60cfca80dfcaa0ffcac11fcae12fcb014fcb216fcb418fbb61afbb81d"
    "fbba1ffbbc21fbbe23fac026fac228fac42afac62df9c72ff9c932f9cb35f8cd37f8cf3a"
    "f7d13df7d340f6d543f6d746f5d949f5db4cf4dd4ff4df53f4e156f3e35af3e55df2e661"
    "f2e865f2ea69f1ec6df1ed71f1ef75f1f179f2f27df2f482f3f586f3f68af4f88ef5f992"
    "f6fa96f8fb9af9fc9dfafda1fcffa4ffffff"
)


def default_colormap_rgba8() -> np.ndarray:
    """(258, 4) uint8: [black, inferno..., white], alpha 255."""
    rgb = np.frombuffer(bytes.fromhex(_RGB_HEX), np.uint8).reshape(-1, 3)
    out = np.empty((rgb.shape[0], 4), np.uint8)
    out[:, :3] = rgb
    out[:, 3] = 255
    return out


def quantize_min_value(colormap_length: int | None) -> int:
    """The ONE definition of min_value, the lowest u16 a quantized pixel
    takes (0 stays the out-of-band black).  floor(x+0.5), not np.round: the
    reference's f64 round() is half-away-from-zero (drawing.rs:21)."""
    if colormap_length is None:
        return 1
    return max(int(np.floor(65535.0 / colormap_length + 0.5)), 1)
