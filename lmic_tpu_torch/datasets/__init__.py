"""Host-side data pipeline (counterpart of lmic_tpu/datasets/): the image
loaders of the training path, the raw video reader and the video clip
folder."""

from lmic_tpu_torch.datasets.image import (  # noqa: F401
    FLIR_TEST_IDS,
    TRAIN_SCALE_ARRAY,
    DataLoader,
    ImageFolder,
    ImageFolderRGB,
    ImageFolderT,
    ImageFolderTest,
    center_crop,
    random_crop,
)
from lmic_tpu_torch.datasets.rawvideo import (  # noqa: F401
    RawVideoSequence,
    VideoFormat,
    get_raw_video_file_info,
)
from lmic_tpu_torch.datasets.video import VideoFolder  # noqa: F401


def prefetch(iterable, size: int = 2):
    """Iterate `iterable` on a background thread with a bounded queue, so
    host-side batch preparation (PIL decode, crop, augment) overlaps the
    device step instead of serializing with it. An error in the worker is
    raised at the consumer; a consumer that stops early releases the
    worker."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    DONE = object()
    stop = threading.Event()

    def put(item) -> bool:
        """Stop-aware put; False when the consumer went away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put(item):
                    return
            put(DONE)
        except BaseException as e:  # surface errors at the consumer
            put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


__all__ = ["FLIR_TEST_IDS", "TRAIN_SCALE_ARRAY", "DataLoader",
           "ImageFolder", "ImageFolderRGB", "ImageFolderT",
           "ImageFolderTest", "RawVideoSequence",
           "VideoFolder", "VideoFormat", "center_crop",
           "get_raw_video_file_info", "prefetch", "random_crop"]
