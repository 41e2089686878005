"""The reference demo: the rod's quaternion and position stacks for the
hard-coded bending strain of ``main.cpp:181-205``, and the tip values
beside the golden ones, ``(0.799770, 0, 0.600307, 0)`` and
``(0.562673, 0, -0.745914)``.  The refined solve, in f64 on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import rod
from ..ops import collocation as coll
from . import parse_args

EXPECTED = "(0.799770, 0, 0.600307, 0) / (0.562673, 0, -0.745914)"


def main(argv=None) -> dict:
    device, _ = parse_args(argv, __doc__)
    qe = rod.demo_qe(torch.float64, device)
    sol = rod.rod_shape(rod.split_strain(qe), method="refined")
    q, r = sol.quaternions_f64(), sol.positions_f64()
    np.set_printoptions(precision=6, suppress=True)
    print("Q_stack (component-major, reference layout):")
    print(coll.to_component_major(q).cpu().numpy())
    print("r_stack:")
    print(r.cpu().numpy())
    tip_q, tip_r = q[0].cpu().numpy(), r[0].cpu().numpy()
    print("\ntip quaternion:", tip_q)
    print("tip position:  ", tip_r)
    print("expected:       " + EXPECTED)
    return {"tip_quaternion": tip_q, "tip_position": tip_r}


if __name__ == "__main__":
    main()
