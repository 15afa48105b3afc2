"""Host-side genomics: encoding, simulation, FASTA/FASTQ and PAF I/O, and
the read pipeline (`pipeline`: ReadBatches, Prefetcher, map_stream)."""
