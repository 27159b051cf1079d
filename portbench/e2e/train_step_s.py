"""Wall time of the window's one ``fit_scene`` call over its steps."""


def read(record):
    if "steps" not in record:
        return None
    return record["window_s"] / record["steps"]
