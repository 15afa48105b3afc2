"""SeGraM building blocks used by the linear mapper (minimizer seeding)."""
