"""dispatch_idle_share (%): over the window's rounds, the replicas' wait
for each round's makespan on the fleet clock, over replicas x makespan:
how far HeMTBatcher's shares miss finishing the replicas together."""
from hemtbench.readers import dispatch_idle_share


def read(rec):
    return dispatch_idle_share(rec)
