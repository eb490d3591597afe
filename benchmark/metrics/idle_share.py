"""``idle_share`` (device): the share of the profiled job's wall time in
which no kernel, copy or fill ran on the card, in percent."""


def read(run):
    if run.profile is None or run.profile.wall_s <= 0:
        return None
    return 100.0 * (1.0 - run.profile.busy_s() / run.profile.wall_s)
