"""Host-side genomics: encoding, simulation, FASTA/FASTQ and PAF I/O."""
