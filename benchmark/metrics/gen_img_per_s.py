"""gen_img_per_s: the images of every completed request over the window,
which runs from the first request's start to the last one's end."""


def read(record):
    if record.get("kind") != "gen":
        return None
    done = sum(r["images"] for r in record["requests"] if r["ok"])
    return done / record["window_s"]
