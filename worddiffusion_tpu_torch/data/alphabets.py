# Copy of worddiffusion_tpu/data/alphabets.py: the port imports nothing of the JAX package.
"""Alphabets and PHOS shape tables for every dataset family.

Character classes mirror the reference configurations:
- ``ENG_BASE``: the original WordStylist IAM alphabet
  (reference ``train.py:55-68``, 52 classes, vocab 53 with PAD).
- ``ENG_MAIN``: the main IAM trainer alphabet with ``_`` as the space
  substitute (reference ``trainModifyCondition.py:68``, 53 classes).
- ``CVL``: extended Latin + digits + punctuation
  (reference ``regenerateFromtrainWord22CVL.py:73``).
- ``NOR``: Norwegian incl. umlauts and ae/oe/aa
  (reference ``regenerateFromtrainWord22CVL.py:76`` /
  ``trainNorModifyCondition.py:60-64``).

PHOS shape-count tables are the public PHOSC-ZSL data tables
(anuj-rai-23/PHOSC-Zero-Shot-Word-Recognition, mirrored by the reference
at ``ResPhoSCNetZSL/modules/utils/Alphabet*.csv``) embedded here as data
so the package is self-contained (the reference loads them from
cluster-absolute paths, ``phos_generator.py:40-45``).
"""

from __future__ import annotations

ENG_BASE = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
ENG_MAIN = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz_"
CVL = (
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
    "=!#&'()*+,-./0123456789:;? \""
)
NOR = (
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
    "äöüæøå=!#&'()*+,-./0123456789:;?_\""
)

ALPHABETS = {
    "eng_base": ENG_BASE,
    "eng_main": ENG_MAIN,
    "cvl": CVL,
    "nor": NOR,
}

# OCR (CTC recognizer) alphabets used by the regeneration filter
# (reference ``regenerateFromtrain2.py:70-92``). For ENG the blank
# symbol is '_' at index 1 (decode strips it); for NOR blank is '_' at
# index 0.
OCR_ENG = " _ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
OCR_ENG_BLANK = 1
OCR_NOR = "_" + "ABCDEFGHIJKLMNOPQRSTUVWXYZÆØÅabcdefghijklmnopqrstuvwxyzæøå"
OCR_NOR_BLANK = 0
# Extended CVL gate covering the full CVL tokenizer alphabet (digits /
# punctuation). Deliberately BEYOND the reference: its CVL regeneration
# keeps the plain-English OCR classes
# (``regenerateFromtrainWord22CVL.py:106`` ``ocr_classes``), so words
# containing digits or punctuation can never pass its exact-match
# filter; this gate can read and accept them. Blank is '_' at index 0
# ('_' is not a CVL alphabet symbol, so decode's blank-strip is safe).
OCR_CVL = "_" + CVL
OCR_CVL_BLANK = 0

# ---------------------------------------------------------------------------
# PHOS shape-count tables.
# Row: character -> per-shape counts. 11 columns (eng/gw), 12 (nor).
# ---------------------------------------------------------------------------

_ENG_ROWS = """
a 0 0 1 0 0 0 1 1 0 0 0
b 1 0 0 0 1 0 1 1 0 0 0
c 0 0 1 0 0 0 0 0 0 0 0
d 1 0 1 0 0 0 1 1 0 0 0
e 0 0 1 0 0 0 0 0 0 0 1
f 1 0 0 0 0 0 0 1 0 0 1
g 0 1 1 0 0 0 1 1 0 0 0
h 1 0 0 0 0 0 0 1 0 0 0
i 0 0 0 0 0 0 0 1 0 0 0
j 0 1 0 0 0 0 0 1 0 0 0
k 1 0 0 0 0 0 0 1 1 1 0
l 1 0 0 0 0 0 0 1 0 0 0
m 0 0 0 0 0 0 0 1 0 0 0
n 0 0 0 0 0 0 0 1 0 0 0
o 0 0 1 0 1 0 1 0 0 0 0
p 0 1 0 0 1 0 1 1 0 0 0
q 0 1 1 0 0 0 1 1 0 0 0
r 0 0 0 0 0 0 0 1 0 0 0
s 0 0 1 0 1 0 0 0 0 0 0
t 0 0 0 0 0 0 0 1 0 0 1
u 0 0 0 0 0 0 0 1 0 0 0
v 0 0 0 0 0 0 0 0 1 1 0
w 0 0 0 0 0 0 0 0 1 1 0
x 0 0 0 0 0 0 0 0 1 1 0
y 0 1 0 0 0 0 0 0 1 1 0
z 0 0 0 0 0 0 0 0 1 0 1
A 0 0 0 0 0 0 0 0 1 1 1
B 1 0 0 0 1 0 1 1 0 0 0
C 0 0 0 1 0 0 0 0 0 0 0
D 1 0 0 0 0 1 1 1 0 0 0
E 1 0 0 0 0 0 0 1 0 0 1
F 1 0 0 0 0 0 0 1 0 0 1
G 0 0 0 1 0 0 0 0 0 0 1
H 1 0 0 0 0 0 0 1 0 0 1
I 1 0 0 0 0 0 0 1 0 0 0
J 1 0 0 0 0 0 0 1 0 0 0
K 1 0 0 0 0 0 0 1 1 1 0
L 1 0 0 0 0 0 0 1 0 0 1
M 1 0 0 0 0 0 0 1 1 1 0
N 1 0 0 0 0 0 0 1 1 1 0
O 0 0 0 1 0 1 1 0 0 0 0
P 1 0 0 0 1 0 1 1 0 0 0
Q 0 0 0 1 0 1 1 0 0 0 0
R 1 0 0 0 1 0 1 1 0 1 0
S 0 0 1 0 1 0 0 0 0 0 0
T 1 0 0 0 0 0 0 1 0 0 1
U 1 0 0 0 0 0 0 1 0 0 0
V 0 0 0 0 0 0 0 0 0 1 0
W 0 0 0 0 0 0 0 0 1 1 0
X 0 0 0 0 0 0 0 0 1 1 0
Y 0 0 0 0 0 0 0 1 1 1 0
Z 0 0 0 0 0 0 0 0 1 0 1
"""

# GW differs from ENG in multi-stroke counts for m/n/u/w/z (counts > 1).
_GW_ROWS = """
a 0 0 1 0 0 0 1 1 0 0 0
b 1 0 0 0 1 0 1 1 0 0 0
c 0 0 1 0 0 0 0 0 0 0 0
d 1 0 1 0 0 0 1 1 0 0 0
e 0 0 1 0 0 0 0 0 0 0 1
f 1 0 0 0 0 0 0 1 0 0 1
g 0 1 1 0 0 0 1 1 0 0 0
h 1 0 0 0 0 0 0 1 0 0 0
i 0 0 0 0 0 0 0 1 0 0 0
j 0 1 0 0 0 0 0 1 0 0 0
k 1 0 0 0 0 0 0 1 1 1 0
l 1 0 0 0 0 0 0 1 0 0 0
m 0 0 0 0 0 0 0 3 0 0 0
n 0 0 0 0 0 0 0 2 0 0 0
o 0 0 1 0 1 0 1 0 0 0 0
p 0 1 0 0 1 0 1 1 0 0 0
q 0 1 1 0 0 0 1 1 0 0 0
r 0 0 0 0 0 0 0 1 0 0 0
s 0 0 1 0 1 0 0 0 0 0 0
t 0 0 0 0 0 0 0 1 0 0 1
u 0 0 0 0 0 0 0 2 0 0 0
v 0 0 0 0 0 0 0 0 1 1 0
w 0 0 0 0 0 0 0 0 2 2 0
x 0 0 0 0 0 0 0 0 1 1 0
y 0 1 0 0 0 0 0 0 1 1 0
z 0 0 0 0 0 0 0 0 1 0 2
A 0 0 0 0 0 0 0 0 1 1 1
B 1 0 0 0 1 0 1 1 0 0 0
C 0 0 0 1 0 0 0 0 0 0 0
D 1 0 0 0 0 1 1 1 0 0 0
E 1 0 0 0 0 0 0 1 0 0 1
F 1 0 0 0 0 0 0 1 0 0 1
G 0 0 0 1 0 0 0 0 0 0 1
H 1 0 0 0 0 0 0 1 0 0 1
I 1 0 0 0 0 0 0 1 0 0 0
J 1 0 0 0 0 0 0 1 0 0 0
K 1 0 0 0 0 0 0 1 1 1 0
L 1 0 0 0 0 0 0 1 0 0 1
M 1 0 0 0 0 0 0 1 1 1 0
N 1 0 0 0 0 0 0 1 1 1 0
O 0 0 0 1 0 1 1 0 0 0 0
P 1 0 0 0 1 0 1 1 0 0 0
Q 0 0 0 1 0 1 1 0 0 0 0
R 1 0 0 0 1 0 1 1 0 1 0
S 0 0 1 0 1 0 0 0 0 0 0
T 1 0 0 0 0 0 0 1 0 0 1
U 1 0 0 0 0 0 0 1 0 0 0
V 0 0 0 0 0 0 0 0 0 1 0
W 0 0 0 0 0 0 0 0 1 1 0
X 0 0 0 0 0 0 0 0 1 1 0
Y 0 0 0 0 0 0 0 1 1 1 0
Z 0 0 0 0 0 0 0 0 1 0 1
"""

# Norwegian: 12 shape columns; note the source table ends with a
# duplicate 'A' row — with dict semantics the later row wins, which we
# reproduce by construction (dict comprehension keeps the last).
_NOR_ROWS = """
a 0 0 1 0 0 0 1 1 0 0 0 0
b 1 0 0 0 1 0 1 1 0 0 0 0
c 0 0 1 0 0 0 0 0 0 0 0 0
d 1 0 1 0 0 0 1 1 0 0 0 0
e 0 0 1 0 0 0 0 0 0 0 1 0
f 1 0 0 0 0 0 0 1 0 0 1 0
g 0 1 1 0 0 0 1 1 0 0 0 0
h 1 0 0 0 0 0 0 1 0 0 0 0
i 0 0 0 0 0 0 0 1 0 0 0 0
j 0 1 0 0 0 0 0 1 0 0 0 0
k 1 0 0 0 0 0 0 1 1 1 0 0
l 1 0 0 0 0 0 0 1 0 0 0 0
m 0 0 0 0 0 0 0 1 0 0 0 0
n 0 0 0 0 0 0 0 1 0 0 0 0
o 0 0 1 0 1 0 1 0 0 0 0 0
p 0 1 0 0 1 0 1 1 0 0 0 0
q 0 1 1 0 0 0 1 1 0 0 0 0
r 0 0 0 0 0 0 0 1 0 0 0 0
s 0 0 1 0 1 0 0 0 0 0 0 0
t 0 0 0 0 0 0 0 1 0 0 1 0
u 0 0 0 0 0 0 0 1 0 0 0 0
v 0 0 0 0 0 0 0 0 1 1 0 0
w 0 0 0 0 0 0 0 0 1 1 0 0
x 0 0 0 0 0 0 0 0 1 1 0 0
y 0 1 0 0 0 0 0 0 1 1 0 0
z 0 0 0 0 0 0 0 0 1 0 1 0
æ 0 0 1 0 0 0 1 1 0 0 1 0
ø 0 0 1 0 1 0 1 0 1 0 0 0
ö 0 0 1 0 1 0 1 0 0 0 0 0
ä 0 0 1 0 0 0 1 1 0 0 0 1
å 0 0 1 0 0 0 1 1 0 0 0 1
ï 0 0 0 0 0 0 0 1 0 0 0 0
ò 0 0 1 0 1 0 1 0 0 0 0 0
ó 0 0 1 0 1 0 1 0 0 0 0 0
A 0 0 0 0 0 0 0 0 1 1 1 0
B 1 0 0 0 1 0 1 1 0 0 0 0
C 0 0 0 1 0 0 0 0 0 0 0 0
D 1 0 0 0 0 1 1 1 0 0 0 0
E 1 0 0 0 0 0 0 1 0 0 1 0
F 1 0 0 0 0 0 0 1 0 0 1 0
G 0 0 0 1 0 0 0 0 0 0 1 0
H 1 0 0 0 0 0 0 1 0 0 1 0
I 1 0 0 0 0 0 0 1 0 0 0 0
J 1 0 0 0 0 0 0 1 0 0 0 0
K 1 0 0 0 0 0 0 1 1 1 0 0
L 1 0 0 0 0 0 0 1 0 0 1 0
M 1 0 0 0 0 0 0 1 1 1 0 0
N 1 0 0 0 0 0 0 1 1 1 0 0
O 0 0 0 1 0 1 1 0 0 0 0 0
P 1 0 0 0 1 0 1 1 0 0 0 0
Q 0 0 0 1 0 1 1 0 0 0 0 0
R 1 0 0 0 1 0 1 1 0 1 0 0
S 0 0 1 0 1 0 0 0 0 0 0 0
T 1 0 0 0 0 0 0 1 0 0 1 0
U 1 0 0 0 0 0 0 1 0 0 0 0
V 0 0 0 0 0 0 0 0 0 1 0 0
W 0 0 0 0 0 0 0 0 1 1 0 0
X 0 0 0 0 0 0 0 0 1 1 0 0
Y 0 0 0 0 0 0 0 1 1 1 0 0
Z 0 0 0 0 0 0 0 0 1 0 1 0
Æ 1 0 0 0 0 0 0 1 1 1 1 0
Ø 0 0 0 1 0 1 1 0 1 0 0 0
Å 0 0 1 0 0 0 1 1 0 0 0 1
A 0 0 0 0 0 0 0 0 1 1 1 0
"""


def _parse(rows: str) -> dict[str, tuple[int, ...]]:
    table: dict[str, tuple[int, ...]] = {}
    for line in rows.strip().splitlines():
        parts = line.split()
        table[parts[0]] = tuple(int(v) for v in parts[1:])
    return table


PHOS_SHAPE_TABLES: dict[str, dict[str, tuple[int, ...]]] = {
    "eng": _parse(_ENG_ROWS),
    "gw": _parse(_GW_ROWS),
    "nor": _parse(_NOR_ROWS),
}

PHOS_NUM_SHAPES = {"eng": 11, "gw": 11, "nor": 12}

# 50 most frequent bigrams used by the PHOC descriptor
# (reference ``phoc_generator.py:52-64``).
PHOC_BIGRAMS = {
    "eng": (
        "th he in er an re es on st nt en at ed nd to or ea ti ar te ng al "
        "it as is ha et se ou of le sa ve ro ra hi ne me de co ta ec si ll "
        "so na li la el ma"
    ).split(),
    "nor": (
        "de og ha je at me fo en ti er mi vi so sa he si ik af sk st ma be "
        "hv al fr va ve om pa et se di da li bl in du no ko an væ fa ku ka "
        "ga hu ta re ud op"
    ).split(),
}
PHOC_BIGRAMS["gw"] = PHOC_BIGRAMS["eng"]

# unigram slot count of the PHOC histogram: [0-9a-z] = 36 for eng/gw,
# +æøå = 39 for nor (reference ``phoc_generator.py:21-24``).
PHOC_NUM_CHARS = {"eng": 36, "gw": 36, "nor": 39}


def phos_dim(version: str) -> int:
    """PHOS length: (1+2+3+4+5) pyramid segments x shape columns."""
    return 15 * PHOS_NUM_SHAPES[version]


def phoc_dim(version: str) -> int:
    """PHOC length: (2+3+4+5) split histograms + 2x50 bigram levels."""
    return 14 * PHOC_NUM_CHARS[version] + 100
