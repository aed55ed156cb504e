"""Spliced (genome x transcript) alignment subsystem.

Reference capability: src/fwd2s.h (DNA cDNA vs genomic DNA with intron
states), src/codepot.cc (splice-site signal models, intron length
penalty), src/gsinfo.cc (gene-structure records and output formats).
"""

from .signals import SpliceSignals
from .penalty import IntronPenalty
