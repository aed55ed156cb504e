"""MSA orchestration: distances, guide trees, weights, progressive
alignment and randomized iterative refinement."""
