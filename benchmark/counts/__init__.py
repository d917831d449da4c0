"""The work of the step counted from the shapes of its calls: the bytes
and operations of each hand-written kernel (``kernels.py``), the VGG16
trunk's operations (``vgg.py``), and the recorder that reads those shapes
from the plain reference's twins of the kernels (``record.py``)."""
