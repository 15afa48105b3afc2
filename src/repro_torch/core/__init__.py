"""GenASM core: bitvectors, DC, TB, the windowed aligner, seeding, mapper,
and the use cases beside them (edit distance with Myers, the pre-alignment
filter, DP baselines and oracles)."""
