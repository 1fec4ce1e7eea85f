"""list_launches.render: block_tiles + list_tiles launches a frame, from the
program's counter listtrace.LAUNCHES reset before each call of the
window."""


def read(rec):
    if rec["kind"] != "render":
        return None
    return sum(rec["launches"]) / len(rec["launches"])
