"""list_launches.train: block_tiles + list_tiles launches a step, from the
program's counter listtrace.LAUNCHES reset before each call of the
window."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return sum(rec["launches"]) / len(rec["launches"])
