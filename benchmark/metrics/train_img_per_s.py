"""train_img_per_s: the rows of every completed train step over the
window, which runs from the first step's start to the last one's end."""


def read(record):
    if record.get("kind") != "train":
        return None
    done = sum(r["images"] for r in record["requests"] if r["ok"])
    return done / record["window_s"]
