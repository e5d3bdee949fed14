"""Qt compatibility layer: PyQt5 when installed, a headless stub otherwise.

The GUI (`app/gui.py`) imports every Qt name from here. With PyQt5 present
this module is a pure re-export (`QT_BACKEND == "pyqt5"`). Without it, a
minimal widget model (`QT_BACKEND == "stub"`) implements the exact API
subset the window uses — signals, layouts, list/label/spin/check widgets,
timers, a synchronous QThread — so the ENTIRE window logic (wiring,
handlers, browser, progress) is constructible and drivable in headless
tests. The stub draws nothing; `gui.main()` still refuses to launch a real
app on the stub backend and points to the CLI.

A copy of the JAX package's `app/qt_compat.py` (it imports no JAX): the
reference ships no GUI tests; here widget-level tests exercise the real
handler code (tests/test_torch_gui.py).
"""
from __future__ import annotations

try:
    from PyQt5.QtCore import Qt, QThread, QTimer, pyqtSignal  # noqa: F401
    from PyQt5.QtGui import QPixmap  # noqa: F401
    from PyQt5.QtWidgets import (  # noqa: F401
        QApplication, QCheckBox, QComboBox, QDialog, QDoubleSpinBox,
        QFileDialog, QGridLayout, QGroupBox, QHBoxLayout, QLabel, QLineEdit,
        QListWidget, QListWidgetItem, QMainWindow, QProgressBar, QPushButton,
        QSpinBox, QSplitter, QTextEdit, QVBoxLayout, QWidget)

    QT_BACKEND = "pyqt5"

except ImportError:  # ---------------- headless stub ----------------------
    import os
    from typing import Any, Callable, List, Optional

    QT_BACKEND = "stub"

    class _Signal:
        """Bound signal instance: connect/emit, synchronous delivery."""

        def __init__(self):
            self._slots: List[Callable] = []

        def connect(self, slot: Callable) -> None:
            self._slots.append(slot)

        def emit(self, *args) -> None:
            for slot in list(self._slots):
                slot(*args)

    class _SignalDescriptor:
        """Class-level pyqtSignal(...) declaration -> per-instance _Signal."""

        def __init__(self, *_types):
            self._name = None

        def __set_name__(self, owner, name):
            self._name = f"__signal_{name}"

        def __get__(self, obj, objtype=None):
            if obj is None:
                return self
            sig = getattr(obj, self._name, None)
            if sig is None:
                sig = _Signal()
                setattr(obj, self._name, sig)
            return sig

    def pyqtSignal(*types):  # noqa: N802 (Qt spelling)
        return _SignalDescriptor(*types)

    class Qt:
        Horizontal = 1
        Vertical = 2
        AlignCenter = 0x84
        KeepAspectRatio = 1
        SmoothTransformation = 1

    class QObjectStub:
        def __init__(self, *args, **kwargs):
            pass

    class QThread(QObjectStub):
        """Synchronous stand-in: start() runs run() inline (deterministic
        for tests; no event loop exists on the stub backend)."""

        def __init__(self, parent=None):
            self._running = False

        def start(self):
            self._running = True
            try:
                self.run()
            finally:
                self._running = False

        def run(self):
            pass

        def isRunning(self):  # noqa: N802
            return self._running

        def wait(self, *a):
            return True

    class QTimer(QObjectStub):
        def __init__(self, parent=None):
            self.timeout = _Signal()
            self._interval = None
            self.active = False

        def start(self, ms=None):
            self._interval = ms
            self.active = True

        def stop(self):
            self.active = False

        def fire(self):  # test helper
            self.timeout.emit()

    class QWidget(QObjectStub):
        def __init__(self, parent=None):
            self._layout = None
            self._enabled = True
            self._tooltip = ""
            self._visible = False

        def setLayout(self, layout):  # noqa: N802
            self._layout = layout

        def setEnabled(self, v):  # noqa: N802
            self._enabled = bool(v)

        def isEnabled(self):  # noqa: N802
            return self._enabled

        def setToolTip(self, t):  # noqa: N802
            self._tooltip = t

        def toolTip(self):  # noqa: N802
            return self._tooltip

        def show(self):
            self._visible = True

        def resize(self, w, h):
            self._size = (w, h)

        def size(self):
            return getattr(self, "_size", (640, 480))

        def setMinimumSize(self, w, h):  # noqa: N802
            pass

        def setMaximumHeight(self, h):  # noqa: N802
            pass

        def setAlignment(self, a):  # noqa: N802
            pass

    class _Layout:
        def __init__(self, parent: Optional[QWidget] = None):
            self.items: List[Any] = []
            if parent is not None:
                parent.setLayout(self)

        def addWidget(self, w, *a):  # noqa: N802
            self.items.append(w)

        def addLayout(self, l, *a):  # noqa: N802
            self.items.append(l)

        def addStretch(self, *a):  # noqa: N802
            pass

        def addSpacing(self, *a):  # noqa: N802
            pass

        def setSpacing(self, *a):  # noqa: N802
            pass

    class QVBoxLayout(_Layout):
        pass

    class QHBoxLayout(_Layout):
        pass

    class QGridLayout(_Layout):
        pass

    class QGroupBox(QWidget):
        def __init__(self, title=""):
            super().__init__()
            self.title = title

    class QSplitter(QWidget):
        def __init__(self, orientation=None):
            super().__init__()
            self.widgets: List[QWidget] = []

        def addWidget(self, w):  # noqa: N802
            self.widgets.append(w)

        def setSizes(self, sizes):  # noqa: N802
            pass

    class QLabel(QWidget):
        def __init__(self, text=""):
            super().__init__()
            self._text = text
            self.pixmap_set = None

        def setText(self, t):  # noqa: N802
            self._text = t

        def text(self):
            return self._text

        def setPixmap(self, p):  # noqa: N802
            self.pixmap_set = p

    class QLineEdit(QWidget):
        def __init__(self, text=""):
            super().__init__()
            self._text = text

        def setText(self, t):  # noqa: N802
            self._text = t

        def text(self):
            return self._text

    class QPushButton(QWidget):
        def __init__(self, text=""):
            super().__init__()
            self._text = text
            self.clicked = _Signal()

        def click(self):  # test helper
            self.clicked.emit()

    class QCheckBox(QWidget):
        def __init__(self, text=""):
            super().__init__()
            self._text = text
            self._checked = False
            self.stateChanged = _Signal()

        def setChecked(self, v):  # noqa: N802
            self._checked = bool(v)
            self.stateChanged.emit(int(v))

        def isChecked(self):  # noqa: N802
            return self._checked

    class QSpinBox(QWidget):
        def __init__(self):
            super().__init__()
            self._value = 0
            self._min, self._max = 0, 99
            self.valueChanged = _Signal()

        def setRange(self, lo, hi):  # noqa: N802
            self._min, self._max = lo, hi

        def setValue(self, v):  # noqa: N802
            self._value = max(self._min, min(self._max, int(v)))
            self.valueChanged.emit(self._value)

        def value(self):
            return self._value

    class QDoubleSpinBox(QWidget):
        def __init__(self):
            super().__init__()
            self._value = 0.0
            self._min, self._max = 0.0, 99.0
            self._step = 1.0
            self.valueChanged = _Signal()

        def setRange(self, lo, hi):  # noqa: N802
            self._min, self._max = float(lo), float(hi)

        def setSingleStep(self, s):  # noqa: N802
            self._step = float(s)

        def setValue(self, v):  # noqa: N802
            self._value = max(self._min, min(self._max, float(v)))
            self.valueChanged.emit(self._value)

        def value(self):
            return self._value

    class QComboBox(QWidget):
        def __init__(self):
            super().__init__()
            self._items: List[str] = []
            self._index = -1
            self.currentIndexChanged = _Signal()

        def addItem(self, text):  # noqa: N802
            self._items.append(str(text))
            if self._index < 0:
                self._index = 0

        def addItems(self, texts):  # noqa: N802
            for t in texts:
                self.addItem(t)

        def currentIndex(self):  # noqa: N802
            return self._index

        def setCurrentIndex(self, i):  # noqa: N802
            if 0 <= i < len(self._items) and i != self._index:
                self._index = i
                self.currentIndexChanged.emit(i)

        def currentText(self):  # noqa: N802
            return self._items[self._index] if self._index >= 0 else ""

        def setCurrentText(self, text):  # noqa: N802
            if text in self._items:
                self.setCurrentIndex(self._items.index(text))

        def count(self):
            return len(self._items)

        def clear(self):
            self._items = []
            self._index = -1

    class QListWidgetItem:
        def __init__(self, text=""):
            self._text = str(text)

        def text(self):
            return self._text

    class QListWidget(QWidget):
        def __init__(self):
            super().__init__()
            self._items: List[QListWidgetItem] = []
            self._row = -1
            self.itemClicked = _Signal()

        def addItem(self, item):  # noqa: N802
            self._items.append(item if isinstance(item, QListWidgetItem)
                               else QListWidgetItem(item))

        def clear(self):
            self._items = []
            self._row = -1

        def count(self):
            return len(self._items)

        def item(self, i):
            return self._items[i]

        def setCurrentRow(self, i):  # noqa: N802
            self._row = i

        def currentItem(self):  # noqa: N802
            return self._items[self._row] if 0 <= self._row < len(self._items) else None

        def click_row(self, i):  # test helper
            self.setCurrentRow(i)
            self.itemClicked.emit(self._items[i])

    class QTextEdit(QWidget):
        def __init__(self):
            super().__init__()
            self._lines: List[str] = []

        def append(self, text):
            self._lines.append(str(text))

        def setText(self, text):  # noqa: N802
            self._lines = [str(text)]

        def toPlainText(self):  # noqa: N802
            return "\n".join(self._lines)

        def setReadOnly(self, v):  # noqa: N802
            pass

    class QProgressBar(QWidget):
        def __init__(self):
            super().__init__()
            self._value, self._max = 0, 100

        def setMaximum(self, v):  # noqa: N802
            self._max = v

        def maximum(self):
            return self._max

        def setValue(self, v):  # noqa: N802
            self._value = v

        def value(self):
            return self._value

    class QMainWindow(QWidget):
        def __init__(self):
            super().__init__()
            self._central = None
            self._title = ""

        def setWindowTitle(self, t):  # noqa: N802
            self._title = t

        def setCentralWidget(self, w):  # noqa: N802
            self._central = w

    class QDialog(QWidget):
        def __init__(self, parent=None):
            super().__init__()
            self._title = ""
            self.accepted = False

        def setWindowTitle(self, t):  # noqa: N802
            self._title = t

        def exec_(self):
            self._visible = True
            return 0

        def accept(self):
            self.accepted = True

    class QFileDialog:
        @staticmethod
        def getExistingDirectory(parent, caption, start):  # noqa: N802
            return ""  # headless: never picks anything

    class QApplication:
        def __init__(self, argv):
            pass

        def exec_(self):
            return 0

    class QPixmap:
        """File-backed stand-in: null iff the file doesn't exist/readable."""

        def __init__(self, path=""):
            self.path = path
            self._null = not (path and os.path.exists(path))

        def isNull(self):  # noqa: N802
            return self._null

        def scaled(self, *a, **k):
            return self
