"""refine_accept_pct (%), layer refine, moves throughput: the
candidates the refinement applied over those it realigned, replays
included (the program's counters ``refine.accepted`` and
``refine.attempted``, read by family like ``k2_launches``) over the
traced window.  None where the program counts no candidate."""

LAYER = "refine"


def read(run):
    attempted = sum(c["refine.attempted"] for c in run.launches)
    if not attempted:
        return None
    return 100.0 * sum(c["refine.accepted"] for c in run.launches) \
        / attempted
