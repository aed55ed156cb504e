"""The benchmark's plain reference of ``prrn -R 0`` on fewer than 16
sequences: a frozen copy of the port's host pipeline (distance matrix,
UPGMA, progressive merges, refinement with conserved regions) whose
kernels are their plain versions (K1 ``wavefront_scores_ref``, K2
``wavefront_core_ref`` and its NumPy restatement ``wavefront_np``, K3
``traceback_ref``), trimmed of every device launch, plan and multi-rank
path and of what this pipeline never reaches.

Copied from ``prrn_aln_tpu_torch`` at the benchmark's first commit and
kept unchanged since, so that a later change to the program is judged
against the alignment the program gave then.  It imports nothing of the
program and nothing of the JAX package.  ``precision.lowered()`` runs it
one float step lower: the benchmark's control.  It runs on the host
alone.
"""
