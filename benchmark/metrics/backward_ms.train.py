"""Wall milliseconds of the train step's backward span
(idccrn.train.backward, autograd's launches included) per step, over the traced steps."""


def read(facts):
    sp = facts.spans
    if facts.kind != "train_step" or sp is None:
        return None
    wall = sp.wall_s.get("idccrn.train.backward")
    return 1e3 * wall / facts.trace_work["steps"] if wall else None
