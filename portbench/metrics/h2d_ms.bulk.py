"""Device ms a request of host-to-device copies (the Predictor's pageable
upload of the crops), from the profiled stretch."""


def read(data):
    return data["summary"]["by_category_ms"].get("H2D copy")
