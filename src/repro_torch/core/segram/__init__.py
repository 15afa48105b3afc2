"""SeGraM: the genome graph, minimizer seeding, BitAlign and the direct mapper."""
