"""Same-shape chunks a stacked IATM=1 pipeline.run dispatched: the chunk
count of MONORTM.LOG's LAYERING line, per run of the traced runs (None
where no LOG has the line)."""


def read(ctx):
    rows = getattr(ctx.driver, "layering", lambda steps: [])(ctx.steps)
    if not rows:
        return None
    return sum(r[2] for r in rows) / len(rows)
