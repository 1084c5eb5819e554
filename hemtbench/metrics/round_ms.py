"""round_ms: the paper's completion time, the mean over the window's
rounds of the round's makespan on the fleet clock (the largest of the
replicas' batch times, each over its replica's speed), in ms."""


def read(rec):
    rounds = rec["rounds"]
    return 1e3 * sum(r["makespan_s"] for r in rounds) / len(rounds) if rounds else None
