"""Sequence-to-graph mapping (SeGraM): windowed BitAlign, the tiled graph
index, the graph mapper and its two alignment backends."""
