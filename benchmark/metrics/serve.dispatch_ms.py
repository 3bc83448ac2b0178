"""Host time of ``InferenceModel.__call__`` (staging included), from the
call to its return, mean over the untraced window's calls, ms."""


def read(records):
    return records["untraced_spans"].mean_ms("serve.call")
