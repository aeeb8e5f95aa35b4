"""Write the JPEG fixtures of this folder with OpenCV:

    python tests/torch_fixtures/jpeg/make_fixtures.py

JPEGs of each chroma sampling, of grey, with a restart interval and with
optimised Huffman tables, each beside OpenCV's decode of it as PNG, and one
``cv2.imencode(".jpg")`` output beside its source image, listed in
``manifest.json``. ``tests/test_torch_jpeg.py`` and ``chip_smoke.py``
(phase codec) hold the port's codec to them without OpenCV.
"""

import json
import os

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLINGS = {"s444": 0x111111, "s422": 0x211111, "s440": 0x121111, "s420": 0x411111}


def source(h=43, w=61, seed=0):
    """Smooth colour gradients, a hard edge and some noise, at a size that
    is not a multiple of any MCU."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([x * 4, y * 5, (x + y) * 2.5], -1)
    img[h // 3 : h // 2, w // 4 : w // 2] = (20, 230, 90)
    img += rs.randn(h, w, 3) * 12
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def main():
    img = source()
    cases = {f"{k}.jpg": [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, v]
             for k, v in SAMPLINGS.items()}
    cases["rst.jpg"] = [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]
    cases["optimized.jpg"] = [cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_QUALITY, 75]
    decode = []
    for name, params in cases.items():
        data = cv2.imencode(".jpg", img, params)[1].tobytes()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        want = name.replace(".jpg", ".color.png")
        cv2.imwrite(os.path.join(HERE, want), cv2.imdecode(np.frombuffer(data, np.uint8), 1))
        decode.append({"jpeg": name, "mode": "color", "want": want})
    grey = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))[1].tobytes()
    with open(os.path.join(HERE, "grey.jpg"), "wb") as f:
        f.write(grey)
    for mode, flag in (("color", cv2.IMREAD_COLOR), ("grayscale", cv2.IMREAD_GRAYSCALE)):
        want = f"grey.{mode}.png"
        cv2.imwrite(os.path.join(HERE, want), cv2.imdecode(np.frombuffer(grey, np.uint8), flag))
        decode.append({"jpeg": "grey.jpg", "mode": mode, "want": want})
    src = source(37, 53, seed=1)
    cv2.imwrite(os.path.join(HERE, "encode_source.png"), src)
    with open(os.path.join(HERE, "encode_q95.jpg"), "wb") as f:
        f.write(cv2.imencode(".jpg", src)[1].tobytes())
    manifest = {"opencv": cv2.__version__, "decode": decode,
                "encode": [{"source": "encode_source.png", "quality": 95,
                            "want": "encode_q95.jpg"}]}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


if __name__ == "__main__":
    main()
