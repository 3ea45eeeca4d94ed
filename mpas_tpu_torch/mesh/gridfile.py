"""MPAS grid.nc ingestion and export (port of mpas_tpu/mesh/gridfile.py).

Implements the reference's mesh file contract (the field catalogue every
core's Registry `input` stream reads, ref: src/core_sw/Registry.xml:54-167:
cellsOnEdge, edgesOnCell, verticesOnEdge, edgesOnEdge/weightsOnEdge,
kiteAreasOnVertex, dvEdge/dcEdge/areaCell/areaTriangle/angleEdge,
meshDensity, fEdge/fVertex/fCell, boundary masks, indexTo*ID) so this
framework can run on meshes generated for the reference (MPAS-Tools /
JIGSAW output) and export its own meshes in the same format.

Conventions translated at this boundary (ref: mpas_bootstrapping.F:79-423
reads these fields verbatim; mpas_block_creator.F reindexes them):
  - file indices are 1-based Fortran with 0 = missing/padding; in-memory
    Mesh indices are 0-based with padded slots pointing at entity 0 and
    carrying zero weight/sign (mesh.py docstring).
  - the file stores primary geometry (areas, lengths, angles, TRiSK
    weights); everything this framework precomputes for the compute
    path (sign arrays, weight bundles divW/keW/curlW, the cell-assembled
    TRiSK factorization triskM, reciprocals) is derived here once,
    host-side, exactly as build_mesh derives it for generated meshes.
"""

from __future__ import annotations

import numpy as np
import torch

from mpas_tpu_torch.io.netcdf import read_netcdf, write_netcdf
from mpas_tpu_torch.mesh.mesh import Mesh

PAD = 0

_CONN_CELL = ("edgesOnCell", "cellsOnCell", "verticesOnCell")
_CONN = _CONN_CELL + ("cellsOnEdge", "verticesOnEdge", "edgesOnEdge",
                      "cellsOnVertex", "edgesOnVertex")


def _latlon(x, y, z, on_sphere):
    if not on_sphere:
        return np.zeros_like(x), np.zeros_like(x)
    r = np.sqrt(x * x + y * y + z * z)
    lat = np.arcsin(np.clip(z / np.maximum(r, 1e-300), -1.0, 1.0))
    lon = np.mod(np.arctan2(y, x), 2.0 * np.pi)
    return lat, lon


def mesh_from_netcdf(path: str) -> Mesh:
    """Read an MPAS-format grid/restart netCDF file (classic or netCDF4)
    into a Mesh of CPU tensors, float64 and int64 as mesh/build.py gives
    them (mesh.to(device, dtype) moves it).

    Accepts any file carrying the Registry mesh catalogue (grid.nc, init.nc,
    restart.nc). Derived arrays (signs, masks, weight bundles, triskM
    factorization, reciprocals) are computed from the file's primary
    fields; nothing is re-generated, so geometry matches the file bitwise.
    """
    want = list(_CONN) + [
        "nEdgesOnCell", "nEdgesOnEdge", "weightsOnEdge",
        "xCell", "yCell", "zCell", "xEdge", "yEdge", "zEdge",
        "xVertex", "yVertex", "zVertex",
        "latCell", "lonCell", "latEdge", "lonEdge", "latVertex", "lonVertex",
        "dvEdge", "dcEdge", "areaCell", "areaTriangle", "angleEdge",
        "kiteAreasOnVertex", "meshDensity", "fEdge", "fVertex", "fCell",
    ]
    allv, dims, attrs = read_netcdf(path)
    f = {k: np.asarray(v) for k, v in allv.items() if k in want}

    def attr(name, default):
        v = attrs.get(name, default)
        if isinstance(v, bytes):
            v = v.decode()
        return v

    on_sphere = str(attr("on_a_sphere", "YES")).strip().upper() in (
        "YES", "TRUE", "Y")
    radius = float(attr("sphere_radius", 1.0)) if on_sphere else 1.0
    x_period = float(attr("x_period", 0.0)) if not on_sphere else 0.0
    y_period = float(attr("y_period", 0.0)) if not on_sphere else 0.0

    nCells = int(dims["nCells"])
    nEdges = int(dims["nEdges"])
    nVertices = int(dims["nVertices"])
    maxEdges = int(dims["maxEdges"])
    maxEdges2 = int(dims.get("maxEdges2", 2 * maxEdges))
    vertexDegree = int(dims["vertexDegree"])

    # --- 1-based -> 0-based; 0 (missing) -> -1 sentinel during derivation --
    conn = {k: f[k].astype(np.int64) - 1 for k in _CONN}
    nEdgesOnCell = f["nEdgesOnCell"].astype(np.int64)
    nEdgesOnEdge = f["nEdgesOnEdge"].astype(np.int64)

    coe = conn["cellsOnEdge"]                      # (nEdges, 2), -1 = open
    voe = conn["verticesOnEdge"]
    eoc = conn["edgesOnCell"]
    eoe = conn["edgesOnEdge"]
    cov = conn["cellsOnVertex"]
    eov = conn["edgesOnVertex"]

    boundaryEdge = ((coe[:, 0] < 0) | (coe[:, 1] < 0)).astype(np.float64)
    boundaryVertex = np.zeros(nVertices)
    bve = voe[boundaryEdge > 0].ravel()
    boundaryVertex[bve[bve >= 0]] = 1.0
    boundaryCell = np.zeros(nCells)
    bce = coe[boundaryEdge > 0].ravel()
    boundaryCell[bce[bce >= 0]] = 1.0

    # --- masks and signs (atm_compute_signs semantics, mpas_atm_core.F:987) -
    eoc_valid = np.arange(maxEdges)[None, :] < nEdgesOnCell[:, None]
    cell_idx = np.arange(nCells)[:, None]
    eoc_c = np.maximum(eoc, 0)
    edgeSignOnCell = np.where(
        eoc_valid & (eoc >= 0),
        np.where(coe[eoc_c, 0] == cell_idx, 1.0, -1.0), 0.0)
    edgesOnCellMask = (eoc_valid & (eoc >= 0)).astype(np.float64)

    vert_idx = np.arange(nVertices)[:, None]
    eov_c = np.maximum(eov, 0)
    edgeSignOnVertex = np.where(
        eov >= 0, np.where(voe[eov_c, 1] == vert_idx, 1.0, -1.0), 0.0)
    cellsOnVertexMask = (cov >= 0).astype(np.float64)

    # --- geometry ----------------------------------------------------------
    dvEdge = f["dvEdge"].astype(np.float64)
    dcEdge = f["dcEdge"].astype(np.float64)
    areaCell = f["areaCell"].astype(np.float64)
    areaTriangle = f["areaTriangle"].astype(np.float64)
    kav = f["kiteAreasOnVertex"].astype(np.float64)
    if kav.shape != (nVertices, vertexDegree):   # Fortran (degree, nVertices)
        kav = kav.T

    xC, yC, zC = (f[k].astype(np.float64) for k in ("xCell", "yCell", "zCell"))
    xE, yE, zE = (f[k].astype(np.float64) for k in ("xEdge", "yEdge", "zEdge"))
    xV, yV, zV = (f[k].astype(np.float64)
                  for k in ("xVertex", "yVertex", "zVertex"))
    latC, lonC = (f["latCell"].astype(np.float64),
                  f["lonCell"].astype(np.float64)) if "latCell" in f \
        else _latlon(xC, yC, zC, on_sphere)
    latE, lonE = (f["latEdge"].astype(np.float64),
                  f["lonEdge"].astype(np.float64)) if "latEdge" in f \
        else _latlon(xE, yE, zE, on_sphere)
    latV, lonV = (f["latVertex"].astype(np.float64),
                  f["lonVertex"].astype(np.float64)) if "latVertex" in f \
        else _latlon(xV, yV, zV, on_sphere)

    weightsOnEdge = f["weightsOnEdge"].astype(np.float64)
    if weightsOnEdge.shape != (nEdges, maxEdges2):
        weightsOnEdge = weightsOnEdge.T
    for k in ("edgesOnEdge",):
        if conn[k].shape != (nEdges, maxEdges2):
            conn[k] = conn[k].T
            eoe = conn[k]

    # --- kites re-indexed per cell (aligned with verticesOnCell) -----------
    voc = conn["verticesOnCell"]
    kiteAreasOnCell = np.zeros((nCells, maxEdges))
    for i in range(vertexDegree):
        # kite (v, cellsOnVertex[v,i]) contributes to that cell's slot of v
        v_ids = np.arange(nVertices)
        c = cov[:, i]
        ok = c >= 0
        # slot of v in verticesOnCell[c]
        slot = np.argmax(voc[np.maximum(c, 0)] == v_ids[:, None], axis=1)
        found = np.take_along_axis(
            voc[np.maximum(c, 0)], slot[:, None], axis=1)[:, 0] == v_ids
        sel = ok & found
        kiteAreasOnCell[c[sel], slot[sel]] = kav[v_ids[sel], i]

    # --- cell-assembled TRiSK factorization from the file's weightsOnEdge --
    # triskM[c, p, i] = w(e_p, e_i) with e_p = edgesOnCell[c, p]; the shared
    # cell of (e, ee) determines where each file weight lands (mesh.py).
    triskM = np.zeros((nCells, maxEdges, maxEdges))
    edgeSlotOnCell = np.zeros((nEdges, 2), dtype=np.int64)
    eids = np.arange(nEdges)
    slot_of = {}  # side -> slot array of e within its side-cell
    for side in range(2):
        c = coe[:, side]
        has = c >= 0
        cc = np.maximum(c, 0)
        j0 = np.argmax(eoc[cc] == eids[:, None], axis=1)
        edgeSlotOnCell[:, side] = np.where(has, j0, 0)
        slot_of[side] = j0

    for j in range(maxEdges2):
        ee = eoe[:, j]
        # validity by sentinel, not by j < nEdgesOnEdge: tolerate both the
        # packed file layout and build_mesh's two-block internal layout
        valid = ee >= 0
        eec = np.maximum(ee, 0)
        w = weightsOnEdge[:, j]
        # shared cell: the cell of e that also contains ee
        for side in range(2):
            c = coe[:, side]
            cc = np.maximum(c, 0)
            shares = (coe[eec, 0] == cc) | (coe[eec, 1] == cc)
            sel = np.where(valid & (c >= 0) & shares)[0]
            if sel.size == 0:
                continue
            slot_e = slot_of[side][sel]
            slot_ee = np.argmax(eoc[cc[sel]] == eec[sel][:, None], axis=1)
            triskM[cc[sel], slot_e, slot_ee] = w[sel]
            valid[sel] = False  # each weight lands in exactly one cell

    meshDensity = f.get("meshDensity",
                        np.ones(nCells)).astype(np.float64)
    fEdge = f.get("fEdge", np.zeros(nEdges)).astype(np.float64)
    fVertex = f.get("fVertex", np.zeros(nVertices)).astype(np.float64)
    fCell = f.get("fCell", np.zeros(nCells)).astype(np.float64)

    def r(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64))

    def i32(x):
        return torch.from_numpy(np.ascontiguousarray(np.maximum(x, 0),
                                                     dtype=np.int64))
    eoc0 = np.maximum(eoc, 0)
    eov0 = np.maximum(eov, 0)
    mesh = Mesh(
        nCells=nCells, nEdges=nEdges, nVertices=nVertices,
        maxEdges=maxEdges, maxEdges2=maxEdges2, vertexDegree=vertexDegree,
        on_sphere=on_sphere, sphere_radius=radius,
        x_period=x_period, y_period=y_period,
        cellsOnEdge=i32(coe), verticesOnEdge=i32(voe),
        edgesOnCell=i32(eoc), nEdgesOnCell=i32(nEdgesOnCell),
        cellsOnCell=i32(conn["cellsOnCell"]), verticesOnCell=i32(voc),
        cellsOnVertex=i32(cov), edgesOnVertex=i32(eov),
        edgesOnEdge=i32(eoe), nEdgesOnEdge=i32(nEdgesOnEdge),
        edgesOnCellMask=r(edgesOnCellMask), edgeSignOnCell=r(edgeSignOnCell),
        edgeSignOnVertex=r(edgeSignOnVertex),
        cellsOnVertexMask=r(cellsOnVertexMask),
        boundaryEdge=r(boundaryEdge), boundaryCell=r(boundaryCell),
        boundaryVertex=r(boundaryVertex),
        xCell=r(xC), yCell=r(yC), zCell=r(zC),
        latCell=r(latC), lonCell=r(lonC),
        xEdge=r(xE), yEdge=r(yE), zEdge=r(zE),
        latEdge=r(latE), lonEdge=r(lonE),
        xVertex=r(xV), yVertex=r(yV), zVertex=r(zV),
        latVertex=r(latV), lonVertex=r(lonV),
        dvEdge=r(dvEdge), dcEdge=r(dcEdge),
        areaCell=r(areaCell), areaTriangle=r(areaTriangle),
        kiteAreasOnVertex=r(kav), kiteAreasOnCell=r(kiteAreasOnCell),
        angleEdge=r(f["angleEdge"]), weightsOnEdge=r(weightsOnEdge),
        triskM=r(triskM), edgeSlotOnCell=i32(edgeSlotOnCell),
        meshDensity=r(meshDensity),
        divW=r(edgeSignOnCell * dvEdge[eoc0]),
        keW=r(0.25 * edgesOnCellMask * (dcEdge * dvEdge)[eoc0]),
        curlW=r(edgeSignOnVertex * dcEdge[eov0]),
        invAreaCell=r(1.0 / np.maximum(areaCell, 1e-300)),
        invAreaTriangle=r(1.0 / np.maximum(areaTriangle, 1e-300)),
        invDvEdge=r(1.0 / np.maximum(dvEdge, 1e-300)),
        invDcEdge=r(1.0 / np.maximum(dcEdge, 1e-300)),
        fEdge=r(fEdge), fVertex=r(fVertex), fCell=r(fCell),
        meshScalingDel2=r(np.ones(nEdges)), meshScalingDel4=r(np.ones(nEdges)),
    )
    mesh.validate()
    return mesh


def packed_edges_on_edge(mesh: Mesh):
    """edgesOnEdge/weightsOnEdge with each row's valid entries packed to
    the front, in order: the reference's file convention (loops run
    j = 1..nEdgesOnEdge, mpas_vector_operations.F:352), which is what
    mesh_from_netcdf gives back. Returns (edgesOnEdge, weightsOnEdge,
    valid mask), numpy.

    The generated mesh's internal layout puts side-0 entries at columns
    0..nEC(c1)-2 and side-1 entries at maxEdges-1..maxEdges-1+nEC(c2)-2
    (build_mesh's column formula); a slot is valid by position, never by
    weight value (exact-zero TRiSK weights occur on symmetric meshes)."""
    g = np.asarray
    coe = g(mesh.cellsOnEdge)
    be = g(mesh.boundaryEdge) > 0
    nEC = g(mesh.nEdgesOnCell).astype(np.int64)
    mE = mesh.maxEdges
    cols = np.arange(mesh.maxEdges2)[None, :]
    n1 = nEC[coe[:, 0]][:, None]
    n2 = np.where(be, 0, nEC[coe[:, 1]])[:, None]
    has = np.where(cols < mE - 1, cols < n1 - 1,
                   (cols - (mE - 1)) < n2 - 1)
    # valid columns first, each row's order kept (a stable sort)
    order = np.argsort(~has, axis=1, kind="stable")
    pmask = np.take_along_axis(has, order, axis=1)
    eoe = np.where(pmask, np.take_along_axis(g(mesh.edgesOnEdge), order,
                                             axis=1), 0)
    woe = np.where(pmask, np.take_along_axis(g(mesh.weightsOnEdge), order,
                                             axis=1), 0.0)
    return eoe, woe, pmask


def mesh_to_netcdf(mesh: Mesh, path: str, fmt: str = "classic"):
    """Write a Mesh as an MPAS-format grid.nc (1-based Fortran convention).

    The file carries the full Registry mesh catalogue, readable by the
    reference model and by mesh_from_netcdf (round-trip tested).

    fmt: "classic" (NetCDF-3 64-bit offset, scipy) or "netcdf4" (HDF5
    container, chunked+shuffle+deflate — the format MPAS-Tools/JIGSAW
    meshes typically ship in; ref: mpas_io.F:144 MPAS_IO_NETCDF4).
    """
    g = lambda a: np.asarray(a)
    i1 = lambda a, mask=None: np.where(
        mask if mask is not None else np.ones(np.shape(a), bool),
        np.asarray(a, dtype=np.int32) + 1, 0).astype(np.int32)

    nC, nE, nV = mesh.nCells, mesh.nEdges, mesh.nVertices
    eoc_mask = g(mesh.edgesOnCellMask) > 0
    # a cell's neighbor slot is missing exactly when the edge there is a
    # boundary edge (cellsOnCell pads with 0, indistinguishable from cell 0)
    coc_mask = eoc_mask & (g(mesh.boundaryEdge)[g(mesh.edgesOnCell)] == 0)
    coe = g(mesh.cellsOnEdge)
    be = g(mesh.boundaryEdge) > 0
    coe_mask = np.ones((nE, 2), bool)
    coe_mask[be, 1] = False   # open side of a boundary edge
    cov_mask = g(mesh.cellsOnVertexMask) > 0
    eov_mask = g(mesh.edgeSignOnVertex) != 0
    eoe_packed, woe_packed, eoe_pmask = packed_edges_on_edge(mesh)

    dims = {
        "Time": None, "nCells": nC, "nEdges": nE, "nVertices": nV,
        "maxEdges": mesh.maxEdges, "maxEdges2": mesh.maxEdges2,
        "TWO": 2, "vertexDegree": mesh.vertexDegree,
    }
    f64 = lambda a: np.asarray(a, dtype=np.float64)
    variables = {
        "indexToCellID": (("nCells",), np.arange(1, nC + 1, dtype=np.int32)),
        "indexToEdgeID": (("nEdges",), np.arange(1, nE + 1, dtype=np.int32)),
        "indexToVertexID": (("nVertices",),
                            np.arange(1, nV + 1, dtype=np.int32)),
        "latCell": (("nCells",), f64(mesh.latCell)),
        "lonCell": (("nCells",), f64(mesh.lonCell)),
        "xCell": (("nCells",), f64(mesh.xCell)),
        "yCell": (("nCells",), f64(mesh.yCell)),
        "zCell": (("nCells",), f64(mesh.zCell)),
        "latEdge": (("nEdges",), f64(mesh.latEdge)),
        "lonEdge": (("nEdges",), f64(mesh.lonEdge)),
        "xEdge": (("nEdges",), f64(mesh.xEdge)),
        "yEdge": (("nEdges",), f64(mesh.yEdge)),
        "zEdge": (("nEdges",), f64(mesh.zEdge)),
        "latVertex": (("nVertices",), f64(mesh.latVertex)),
        "lonVertex": (("nVertices",), f64(mesh.lonVertex)),
        "xVertex": (("nVertices",), f64(mesh.xVertex)),
        "yVertex": (("nVertices",), f64(mesh.yVertex)),
        "zVertex": (("nVertices",), f64(mesh.zVertex)),
        "meshDensity": (("nCells",), f64(mesh.meshDensity)),
        "cellsOnEdge": (("nEdges", "TWO"), i1(coe, coe_mask)),
        "verticesOnEdge": (("nEdges", "TWO"), i1(mesh.verticesOnEdge)),
        "nEdgesOnCell": (("nCells",), g(mesh.nEdgesOnCell).astype(np.int32)),
        "nEdgesOnEdge": (("nEdges",), g(mesh.nEdgesOnEdge).astype(np.int32)),
        "edgesOnCell": (("nCells", "maxEdges"),
                        i1(mesh.edgesOnCell, eoc_mask)),
        "edgesOnEdge": (("nEdges", "maxEdges2"),
                        i1(eoe_packed, eoe_pmask)),
        "weightsOnEdge": (("nEdges", "maxEdges2"), f64(woe_packed)),
        "dvEdge": (("nEdges",), f64(mesh.dvEdge)),
        "dcEdge": (("nEdges",), f64(mesh.dcEdge)),
        "angleEdge": (("nEdges",), f64(mesh.angleEdge)),
        "areaCell": (("nCells",), f64(mesh.areaCell)),
        "areaTriangle": (("nVertices",), f64(mesh.areaTriangle)),
        "cellsOnCell": (("nCells", "maxEdges"),
                        i1(mesh.cellsOnCell, coc_mask)),
        "verticesOnCell": (("nCells", "maxEdges"),
                           i1(mesh.verticesOnCell, eoc_mask)),
        "cellsOnVertex": (("nVertices", "vertexDegree"),
                          i1(mesh.cellsOnVertex, cov_mask)),
        "edgesOnVertex": (("nVertices", "vertexDegree"),
                          i1(mesh.edgesOnVertex, eov_mask)),
        "kiteAreasOnVertex": (("nVertices", "vertexDegree"),
                              f64(mesh.kiteAreasOnVertex)),
        "fEdge": (("nEdges",), f64(mesh.fEdge)),
        "fVertex": (("nVertices",), f64(mesh.fVertex)),
        "fCell": (("nCells",), f64(mesh.fCell)),
        "boundaryEdge": (("nEdges",),
                         g(mesh.boundaryEdge).astype(np.int32)),
        "boundaryVertex": (("nVertices",),
                           g(mesh.boundaryVertex).astype(np.int32)),
        "boundaryCell": (("nCells",),
                         g(mesh.boundaryCell).astype(np.int32)),
        "meshScalingDel2": (("nEdges",), f64(mesh.meshScalingDel2)),
        "meshScalingDel4": (("nEdges",), f64(mesh.meshScalingDel4)),
    }
    attrs = {
        "on_a_sphere": "YES" if mesh.on_sphere else "NO",
        "sphere_radius": float(mesh.sphere_radius) if mesh.on_sphere else 0.0,
        "is_periodic": "YES" if (mesh.x_period or mesh.y_period) else "NO",
        "x_period": float(mesh.x_period), "y_period": float(mesh.y_period),
        "mesh_spec": "1.0", "source": "mpas_tpu",
    }
    if fmt == "netcdf4":
        from mpas_tpu_torch.io.hdf5_write import write_hdf5
        dims4 = {k: (1 if v is None else v) for k, v in dims.items()}
        write_hdf5(path, dims4, variables, attrs, compress=True,
                   chunk_rows=max(64, mesh.nCells // 8))
    else:
        write_netcdf(path, dims, variables, attrs)
