"""Mean host ms per step that the trainer's loop spends in `next()` on the
port's DataLoader (the harness's span), over every step of the window and
of the traced steps after it, averaged over the ranks."""

from portbench.metrics._common import mean, ranks


def read(obs):
    return mean(1e3 * sum(o["spans"]["loader.next"]) / len(o["spans"]["loader.next"])
                for o in ranks(obs) if o.get("spans", {}).get("loader.next"))
