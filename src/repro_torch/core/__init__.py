"""GenASM core: bitvectors, DC, TB, the windowed aligner, seeding, mapper."""
